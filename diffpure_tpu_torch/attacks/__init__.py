from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
from diffpure_tpu_torch.attacks.autoattack import AutoAttack, AutoAttackConfig
from diffpure_tpu_torch.attacks.bpda_eot import BPDAEOTConfig, bpda_eot_attack, \
    defense_predict
from diffpure_tpu_torch.attacks.fab import FABConfig, fab_attack
from diffpure_tpu_torch.attacks.mister_ed import CarliniWagnerConfig, MisterEdPGDConfig, \
    carlini_wagner, fgsm, perturbation_pgd
from diffpure_tpu_torch.attacks.pgd import PGDConfig, pgd_attack
from diffpure_tpu_torch.attacks.square import SquareConfig, square_attack
from diffpure_tpu_torch.attacks.stadv import StAdvConfig, stadv_attack
from diffpure_tpu_torch.attacks.losses import ce_loss, cw_f6_loss, \
    dlr_loss, dlr_loss_targeted, margin_loss

__all__ = ["APGDConfig", "apgd_attack", "AutoAttack", "AutoAttackConfig",
           "BPDAEOTConfig", "bpda_eot_attack", "defense_predict",
           "FABConfig", "fab_attack", "PGDConfig", "pgd_attack",
           "MisterEdPGDConfig", "perturbation_pgd", "fgsm", "CarliniWagnerConfig",
           "carlini_wagner", "SquareConfig", "square_attack",
           "StAdvConfig", "stadv_attack",
           "ce_loss", "cw_f6_loss", "dlr_loss", "dlr_loss_targeted",
           "margin_loss"]
