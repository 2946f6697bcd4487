from diffpure_tpu_torch.diffusion.score import get_score_fn
from diffpure_tpu_torch.diffusion.sde import VPSDE, batch_mul
