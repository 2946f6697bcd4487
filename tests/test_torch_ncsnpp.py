"""A small NCSN++ in the port (plain versions of the fused blocks) against
diffpure_tpu's NCSNpp.apply on the same seeded weights, fp32 and bf16.

fp32 goes against the JAX model's unfused graph (its CPU default). bf16
goes against the JAX model with its Pallas block kernels forced on
(interpret mode): the port's blocks follow those kernels' roundings, while
the unfused bf16 graph rounds at other places and lands about 1% (max abs,
relative to max |ref|) away from either.
"""
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.models import layers as jax_layers
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu_torch.config import load_config
from diffpure_tpu_torch.models import NCSNpp, ncsnpp_from_config
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import DTYPES, REL, assert_close, normal

# plain, down, up, concat and attention blocks at 16x16 and 8x8
SMALL = dict(nf=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
             image_size=16)


@pytest.fixture(scope="module")
def weights():
    model = NCSNpp(**SMALL).eval()
    sd = seeded_normal_state_dict(model, 0)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, translate_ncsnpp(sd)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_small_ncsnpp_matches_jax(weights, dtype):
    jdt, tdt = DTYPES[dtype]
    model, params = weights
    model.dtype = tdt
    rng = np.random.default_rng(1)
    x = normal(rng, 2, 16, 16, 3)
    labels = np.array([999.0 * 0.1, 999.0 * 0.7], np.float32)
    jax_layers.set_fused_resblock(dtype == "bfloat16")
    try:
        want = JaxNCSNpp(**SMALL, dtype=jdt).apply(params, jnp.asarray(x),
                                                    jnp.asarray(labels))
    finally:
        jax_layers.set_fused_resblock("auto")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert_close(got, want, REL[dtype], f"NCSN++ {dtype}")


def test_cifar10_config_builds_the_benched_model():
    cfg = load_config(str(Path(__file__).resolve().parent.parent
                          / "configs" / "cifar10.yml"))
    with torch.device("meta"):
        model = ncsnpp_from_config(cfg)
    assert sum(p.numel() for p in model.parameters()) == 106_632_579


def test_unported_options_raise():
    """Every option value JAX's NCSN++ takes builds (FIR, the pyramids, the
    Fourier embedding, unconditional, uncentered: tests/test_torch_ncsnpp_ve.py
    holds them against JAX); a value it does not take raises."""
    small = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                 image_size=16)
    NCSNpp(**small, fir=True, progressive="output_skip", progressive_input="input_skip",
           progressive_combine="cat", embedding_type="fourier", conditional=False,
           scale_by_sigma=True, centered=False)
    for kw in (dict(progressive="bogus"), dict(progressive_input="skip"),
               dict(progressive_combine="max"), dict(embedding_type="learned"),
               dict(resblock_type="unet")):
        with pytest.raises(ValueError):
            NCSNpp(**small, **kw)


def test_block_caches_follow_weight_edits():
    """The blocks cache weights derived per dtype (kernel pack, the cast
    Dense_0); an in-place edit of a weight, or moving the module under
    inference_mode, must not leave a stale copy behind."""
    from diffpure_tpu_torch.models.layers import ResnetBlockBigGANpp
    blk = ResnetBlockBigGANpp(8, 8, temb_dim=16).eval()
    x, t = torch.randn(1, 4, 4, 8), torch.randn(1, 16)
    with torch.inference_mode():
        y0 = blk(x, t)
    with torch.no_grad():
        blk.Dense_0.weight.mul_(2.0)
    with torch.inference_mode():
        y1 = blk(x, t)
        blk.to(torch.float64).to(torch.float32)  # parameters become inference tensors
        y2 = blk(x, t)
    assert not torch.equal(y0, y1)
    assert torch.equal(y1, y2)
