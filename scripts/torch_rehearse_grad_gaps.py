"""CPU rehearsal of chip_smoke.py's gradient bounds (phases 15 and 18): how
far the port's plain bf16 input gradient lies from its plain fp32 one.

    python scripts/torch_rehearse_grad_gaps.py [adm widths ...]

- the ImageNet purification: d/dx sum(w * DefendedModel(resize_to=256)
  .purify(x)) through an ADM of imagenet256_config's structure at the given
  channel widths (default 64 and 128; the full width, 256, takes minutes
  a gradient on a CPU), batch 1, guided purify_sde at t*=2, both grad
  modes, the same noise in both dtypes;
- one evaluation of NCSN++ with resblock_type='ddpm' (2 blocks a level, the
  full width), batch 2: d/dx sum(w * score(x, t)), three seeds.

Prints max |bf16 - fp32| / max |fp32| for each. Runs on the CPU only.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from diffpure_tpu_torch.eval import DefendedModel  # noqa: E402
from diffpure_tpu_torch.models import ADMUNet, NCSNpp, imagenet256_config  # noqa: E402
from diffpure_tpu_torch.purify import PurifyConfig, SeededNoise  # noqa: E402
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict  # noqa: E402


def seeded(model, seed):
    model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                           for k, v in seeded_normal_state_dict(model, seed).items()})
    return model.eval().requires_grad_(False)


def gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def adm_gaps(width):
    cfg = imagenet256_config()
    cfg["model_channels"] = width
    model = seeded(ADMUNet(**cfg), 0)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(1, 224, 224, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 256, 256, 3)).astype(np.float32))
    for mode in ("checkpoint", "adjoint"):
        grads = {}
        for dtype in (torch.float32, torch.bfloat16):
            model.dtype = dtype
            dm = DefendedModel(model, None, PurifyConfig(t=2, score_type="guided_diffusion",
                                                         grad_mode=mode),
                               log_every=0, resize_to=256)
            xt = x.clone().requires_grad_(True)
            t0 = time.time()
            (grads[dtype],) = torch.autograd.grad((w * dm.purify(xt, SeededNoise(5))).sum(), xt)
            print(f"  ADM {width} channels, {mode}, {dtype}: {time.time() - t0:.1f} s", flush=True)
        print(f"ADM {width} channels, {mode}: plain bf16 vs fp32 "
              f"{gap(grads[torch.bfloat16], grads[torch.float32]):.3e}", flush=True)


def ncsnpp_ddpm_gaps():
    model = seeded(NCSNpp(resblock_type="ddpm", num_res_blocks=2), 23)
    gaps = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        xs = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32) * 0.5)
        w = torch.from_numpy(rng.standard_normal((2, 32, 32, 3)).astype(np.float32))
        ts = torch.tensor([99.9, 500.0])
        grads = {}
        for dtype in (torch.float32, torch.bfloat16):
            model.dtype = dtype
            xx = xs.clone().requires_grad_(True)
            (grads[dtype],) = torch.autograd.grad((w * model(xx, ts).float()).sum(), xx)
        gaps.append(gap(grads[torch.bfloat16], grads[torch.float32]))
    print("NCSN++ 'ddpm' evaluation: plain bf16 vs fp32 " + ", ".join(f"{g:.3e}" for g in gaps))


if __name__ == "__main__":
    for width in [int(a) for a in sys.argv[1:]] or [64, 128]:
        adm_gaps(width)
    ncsnpp_ddpm_gaps()
