from diffpure_tpu_torch.purify.config import PurifyConfig
from diffpure_tpu_torch.purify.runners import SeededNoise, purify, purify_dpm, \
    purify_ldsde, purify_ode, purify_sde
