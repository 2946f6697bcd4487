from diffpure_tpu_torch.utils.logging import Logger, setup_run_logging
from diffpure_tpu_torch.utils.prng import seed_everything

__all__ = ["Logger", "setup_run_logging", "seed_everything"]
