from diffpure_tpu_torch.diffusion.discrete import GaussianDiffusion, ModelMeanType, \
    ModelVarType, SpacedDiffusion
from diffpure_tpu_torch.diffusion.schedules import cosine_beta_schedule, \
    get_named_beta_schedule, linear_beta_schedule, space_timesteps
from diffpure_tpu_torch.diffusion.score import eps_to_score_continuous_vp, \
    get_score_fn, make_guided_score_fn
from diffpure_tpu_torch.diffusion.sde import VPSDE, batch_mul
