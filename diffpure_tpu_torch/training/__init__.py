from diffpure_tpu_torch.training.losses import (
    get_ddpm_loss_fn,
    get_optimizer,
    get_sde_loss_fn,
    get_smld_loss_fn,
    get_step_fn,
    optimization_manager,
)

__all__ = ["get_optimizer", "optimization_manager", "get_sde_loss_fn",
           "get_smld_loss_fn", "get_ddpm_loss_fn", "get_step_fn"]
