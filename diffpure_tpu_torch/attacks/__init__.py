from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
from diffpure_tpu_torch.attacks.autoattack import AutoAttack, AutoAttackConfig
from diffpure_tpu_torch.attacks.bpda_eot import BPDAEOTConfig, bpda_eot_attack, \
    defense_predict
from diffpure_tpu_torch.attacks.fab import FABConfig, fab_attack
from diffpure_tpu_torch.attacks.square import SquareConfig, square_attack
from diffpure_tpu_torch.attacks.losses import ce_loss, cw_f6_loss, \
    dlr_loss, dlr_loss_targeted, margin_loss

__all__ = ["APGDConfig", "apgd_attack", "AutoAttack", "AutoAttackConfig",
           "BPDAEOTConfig", "bpda_eot_attack", "defense_predict",
           "FABConfig", "fab_attack", "SquareConfig", "square_attack",
           "ce_loss", "cw_f6_loss", "dlr_loss", "dlr_loss_targeted",
           "margin_loss"]
