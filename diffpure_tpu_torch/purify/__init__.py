from diffpure_tpu_torch.purify.config import PurifyConfig
from diffpure_tpu_torch.purify.runners import DiscreteNoise, SeededNoise, \
    make_imagenet_diffusion, purify, purify_celebahq_ddpm, purify_dpm, \
    purify_guided_ddpm, purify_ldsde, purify_ode, purify_sde
