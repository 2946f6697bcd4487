from diffpure_tpu_torch.models.adm_unet import ADMUNet, EncoderUNetADM, SuperResADM, \
    imagenet256_config
from diffpure_tpu_torch.models.ddpm_unet import DDPMUNet
from diffpure_tpu_torch.models.ddpm_v1 import DDPM
from diffpure_tpu_torch.models.factories import adm_from_config, classifier_defaults, \
    create_classifier, create_classifier_and_diffusion, create_gaussian_diffusion, \
    create_model, create_model_and_diffusion, model_and_diffusion_defaults, \
    ncsnpp_from_config, sr_create_model, sr_create_model_and_diffusion, \
    sr_model_and_diffusion_defaults
from diffpure_tpu_torch.models.ncsnpp import NCSNpp
from diffpure_tpu_torch.models.ncsnv2 import NCSN, NCSNv2, NCSNv2_128, NCSNv2_256, \
    get_network
