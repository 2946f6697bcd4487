from diffpure_tpu_torch.diffusion.score import eps_to_score_continuous_vp, \
    get_score_fn, make_guided_score_fn
from diffpure_tpu_torch.diffusion.sde import VPSDE, batch_mul
