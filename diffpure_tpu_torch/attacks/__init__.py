from diffpure_tpu_torch.attacks.apgd import APGDConfig, apgd_attack
from diffpure_tpu_torch.attacks.autoattack import AutoAttack, AutoAttackConfig
from diffpure_tpu_torch.attacks.losses import ce_loss, cw_f6_loss, \
    dlr_loss, dlr_loss_targeted, margin_loss

__all__ = ["APGDConfig", "apgd_attack", "AutoAttack", "AutoAttackConfig",
           "ce_loss", "cw_f6_loss", "dlr_loss", "dlr_loss_targeted",
           "margin_loss"]
