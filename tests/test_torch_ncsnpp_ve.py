"""NCSN++'s FIR, progressive and Fourier options in the port against
diffpure_tpu's NCSNpp.apply (jitted) on the same seeded weights, and
score_sde's VE NCSN++ (configs/cifar10_ve.yml) at full width on the meta
device.

Small models (nf 16, ch_mult (1, 2), one block a level, attention at 8)
cover FIR on and off for each (progressive, progressive_input) pair of
{(none, residual), (output_skip, input_skip), (residual, residual)},
progressive_combine sum and cat, Fourier and positional embeddings,
scale_by_sigma, centered=False, conditional=False and the DDPM++ blocks'
FIR layers; fp32 at 1e-4 of the largest JAX value. bf16 on VE's options
holds the port against JAX with its Pallas blocks on (interpret mode), at
the suite's bf16 bound, 1e-2: the two sides' bf16 outputs sit about 1%
from fp32 along different rounding paths (tests/test_torch_ncsnpp.py).
"""
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpure_tpu.config import load_config as jax_load_config
from diffpure_tpu.models import layers as jax_layers
from diffpure_tpu.models.convert import translate_ncsnpp
from diffpure_tpu.models.factories import ncsnpp_from_config as jax_ncsnpp_from_config
from diffpure_tpu.models.ncsnpp import NCSNpp as JaxNCSNpp
from diffpure_tpu_torch.config import load_config
from diffpure_tpu_torch.models import NCSNpp, ncsnpp_from_config
from diffpure_tpu_torch.models import layers
from diffpure_tpu_torch.models.convert import flatten_params, ncsnpp_state_dict_from_flax
from diffpure_tpu_torch.ops import fused_attnblock as fab
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict
from torch_parity import DTYPES, REL, assert_close, normal, two_torch_threads  # noqa: F401

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SMALL = dict(nf=16, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), image_size=16)
VE = dict(fir=True, progressive="none", progressive_input="residual",
          progressive_combine="sum", embedding_type="fourier", scale_by_sigma=True,
          centered=False)
CASES = {
    "ve": VE,
    "ve_no_fir": dict(VE, fir=False, embedding_type="positional"),
    "skips_fir_sum": dict(fir=True, progressive="output_skip", progressive_input="input_skip"),
    "skips_cat_fourier": dict(fir=False, progressive="output_skip",
                              progressive_input="input_skip", progressive_combine="cat",
                              embedding_type="fourier"),
    "residual_fir_fourier": dict(fir=True, progressive="residual", progressive_input="residual",
                                 embedding_type="fourier", scale_by_sigma=True),
    "residual_uncentered": dict(fir=False, progressive="residual",
                                progressive_input="residual", centered=False),
    "skips_cat_fir_unconditional": dict(fir=True, progressive="output_skip",
                                        progressive_input="input_skip",
                                        progressive_combine="cat", conditional=False),
    "ddpm_blocks_fir": dict(fir=True, resblock_type="ddpm", progressive="output_skip",
                            progressive_input="residual"),
}
VE_COUNTS = {"fused_resblock": 18, "fused_resblock_cat": 20, "fused_attnblock": 6, "plain": 6}


def _labels(cfg):
    if cfg.get("embedding_type") == "fourier":
        return np.array([0.02, 31.0], np.float32)  # noise scales sigma
    return np.array([99.9, 700.0], np.float32)  # t * 999


def _weights(cfg):
    model = NCSNpp(**SMALL, **cfg).eval()
    sd = seeded_normal_state_dict(model, 0)
    if cfg.get("embedding_type") == "fourier":  # fourier_scale 16, as initialised
        sd["all_modules.0.W"] = 16.0 * normal(np.random.default_rng(3), 16)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return model, sd


@pytest.mark.parametrize("case", list(CASES))
def test_small_ncsnpp_options_match_jax(case, two_torch_threads):  # noqa: F811
    cfg = CASES[case]
    model, sd = _weights(cfg)
    params = translate_ncsnpp(sd)
    # the converter: every flax leaf to exactly one port tensor, none left over
    back = ncsnpp_state_dict_from_flax(params)
    assert sorted(back) == sorted(sd)
    for k, v in back.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert len(list(flatten_params(params))) == len(sd) - 1  # all but the sigmas buffer
    x = normal(np.random.default_rng(1), 2, 16, 16, 3)
    if not cfg.get("centered", True):
        x = x * 0.5 + 0.5
    labels = _labels(cfg)
    want = jax.jit(JaxNCSNpp(**SMALL, **cfg).apply)(params, jnp.asarray(x), jnp.asarray(labels))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert_close(got, want, REL["float32"], f"NCSN++ {case} fp32")


def test_small_ve_ncsnpp_bf16_matches_jax(two_torch_threads):  # noqa: F811
    jdt, tdt = DTYPES["bfloat16"]
    model, sd = _weights(VE)
    model.dtype = tdt
    x = normal(np.random.default_rng(1), 2, 16, 16, 3) * 0.5 + 0.5
    labels = _labels(VE)
    jax_layers.set_fused_resblock(True)
    try:
        want = jax.jit(JaxNCSNpp(**SMALL, **VE, dtype=jdt).apply)(
            translate_ncsnpp(sd), jnp.asarray(x), jnp.asarray(labels))
    finally:
        jax_layers.set_fused_resblock("auto")
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    assert_close(got, want, REL["bfloat16"], "VE NCSN++ bf16")


def test_fir_blocks_take_the_plain_path_and_others_the_wrappers(monkeypatch):
    """JAX's gate: a BigGAN block that resamples with FIR runs the plain
    graph, every other block the kernel wrappers (on the CPU, their plain
    versions)."""
    model, _ = _weights(VE)
    calls = Counter()
    for name in ("fused_resblock", "fused_resblock_cat", "fused_attnblock"):
        real = getattr(layers, name)

        def wrapped(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(layers, name, wrapped)
    real_plain = layers.ResnetBlockBigGANpp._forward_plain

    def plain(self, *a, **k):
        calls["plain"] += 1
        assert self.resample != "none" and self.fir_kernel == (1, 3, 3, 1)
        return real_plain(self, *a, **k)

    monkeypatch.setattr(layers.ResnetBlockBigGANpp, "_forward_plain", plain)
    with torch.inference_mode():
        model(torch.rand(1, 16, 16, 3), torch.tensor([3.0]))
    # one block a level: 2 down + 2 middle, 2 x 2 up, 1 down and 1 up resampling
    assert calls == {"fused_resblock": 4, "fused_resblock_cat": 4, "fused_attnblock": 3,
                     "plain": 2}


def test_unconditional_blocks_have_no_dense_and_run_plain():
    model = NCSNpp(**SMALL, conditional=False)
    blocks = [m for m in model.modules() if isinstance(m, layers.ResnetBlockBigGANpp)]
    assert blocks and all(b.plain and not hasattr(b, "Dense_0") for b in blocks)


def _census(cfg_path):
    """(kind, resample, H, c1, c2, cout) -> calls over one evaluation of the
    full-width model of ``cfg_path``, walked on the meta device with the
    blocks replaced by recorders: 'plain' for the BigGAN blocks JAX's gate
    sends to the unfused graph."""
    seen = Counter()

    def block(self, x, temb=None, **kw):
        cout = self.Conv_0.out_channels
        if isinstance(x, tuple):
            n, H, _, c1 = x[0].shape
            c2 = x[1].shape[3]
        else:
            (n, H, _, c1), c2 = x.shape, 0
        if self.plain:
            kind = "plain"
        elif c2 and self.has_proj and self.resample == "none":
            kind = "fused_resblock_cat"
        else:
            kind, c1, c2 = "fused_resblock", c1 + c2, 0
        seen[(kind, self.resample, H, c1, c2, cout)] += 1
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[self.resample]
        return torch.empty(n, Ho, Ho, cout, device="meta")

    def attn(self, x):
        seen[("fused_attnblock", "none", x.shape[1], x.shape[3], 0, x.shape[3])] += 1
        return x

    mp = pytest.MonkeyPatch()
    mp.setattr(layers.ResnetBlockBigGANpp, "forward", block)
    mp.setattr(layers.AttnBlockpp, "forward", attn)
    try:
        with torch.device("meta"):
            model = ncsnpp_from_config(load_config(str(cfg_path)))
            model(torch.empty(2, 32, 32, 3), torch.ones(2))
    finally:
        mp.undo()
    return dict(seen)


def test_full_width_ve_config_matches_jax_and_its_census_fits_the_kernels():
    """configs/cifar10_ve.yml: the port's parameter count equals JAX's
    model.init (eval_shape); one evaluation launches #1 18 times, #2 20 and
    #3 6, and runs 6 FIR blocks (3 down, 3 up) plain; every kernel shape
    is one of the VP model's (configs/cifar10.yml), and the bf16 and fp32
    plans take it at batch 2, 8 and 64."""
    cfg_path = CONFIGS / "cifar10_ve.yml"
    with torch.device("meta"):
        model = ncsnpp_from_config(load_config(str(cfg_path)))
    n_port = sum(p.numel() for p in model.parameters())
    jm = jax_ncsnpp_from_config(jax_load_config(str(cfg_path)))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                            jnp.ones((1,))))
    n_jax = sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(shapes))
    assert n_port == n_jax == 62_758_915
    ve, vp = _census(cfg_path), _census(CONFIGS / "cifar10.yml")
    calls = Counter()
    for (kind, *_), n in ve.items():
        calls[kind] += n
    assert calls == VE_COUNTS
    assert sorted(s[1] for s in ve if s[0] == "plain") == ["down"] * 3 + ["up"] * 3
    kernel_shapes = {s for s in ve if s[0] != "plain"}
    assert kernel_shapes <= set(vp), kernel_shapes - set(vp)
    for (kind, rs, H, c1, c2, cout) in sorted(kernel_shapes):
        for batch in (2, 8, 64):
            for dtype in (torch.bfloat16, torch.float32):
                if kind == "fused_attnblock":
                    fab.check_attnblock_shape(dtype, batch, H, H, c1, min(c1 // 4, 32))
                    if dtype == torch.float32:
                        fab.attnblock_f32_plan(batch, H, H, c1, min(c1 // 4, 32))
                    continue
                cin = c1 + c2
                proj = kind == "fused_resblock_cat" or rs != "none" or cin != cout
                frb.check_resblock_shape(dtype, batch, H, H, c1, c2, cout, rs, proj,
                                         min(cin // 4, 32), min(cout // 4, 32))


def test_score_sde_checkpoint_of_the_ve_model_loads(tmp_path):
    """A score_sde checkpoint of the VE options (DataParallel's prefix, the
    EMA's shadow parameters in parameters() order) loads through
    load_score_sde_checkpoint with score_sde's keys: score_sde's EMA skips
    the frozen Fourier W, which keeps the model's value; a shadow of every
    parameter (the port's EMA) maps one to one."""
    from diffpure_tpu_torch.models.convert import load_score_sde_checkpoint

    model, sd = _weights(VE)
    names = [k for k, _ in model.named_parameters()]
    for skip_frozen in (True, False):
        kept = [k for k in names if not (skip_frozen and k == "all_modules.0.W")]
        shadow = [torch.from_numpy(sd[k]) * 0.5 for k in kept]
        path = tmp_path / f"checkpoint_{skip_frozen}.pth"
        torch.save({"model": {"module." + k: torch.from_numpy(v) for k, v in sd.items()},
                    "ema": {"shadow_params": shadow}, "step": 1}, path)
        fresh = NCSNpp(**SMALL, **VE)
        fresh.load_state_dict(load_score_sde_checkpoint(str(path)), strict=True)
        got = dict(fresh.named_parameters())
        for k, s in zip(kept, shadow):
            torch.testing.assert_close(got[k].detach(), s, rtol=0, atol=0, msg=k)
        w = got["all_modules.0.W"]
        assert not w.requires_grad
        np.testing.assert_array_equal(w.detach().numpy(),
                                      sd["all_modules.0.W"] * (1.0 if skip_frozen else 0.5))
