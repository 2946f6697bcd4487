from diffpure_tpu_torch.models.adm_unet import ADMUNet, imagenet256_config
from diffpure_tpu_torch.models.ddpm_unet import DDPMUNet
from diffpure_tpu_torch.models.ddpm_v1 import DDPM
from diffpure_tpu_torch.models.factories import adm_from_config, create_model, \
    model_and_diffusion_defaults, ncsnpp_from_config
from diffpure_tpu_torch.models.ncsnpp import NCSNpp
from diffpure_tpu_torch.models.ncsnv2 import NCSN, NCSNv2, NCSNv2_128, NCSNv2_256, \
    get_network
