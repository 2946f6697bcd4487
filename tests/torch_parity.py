"""Helpers for the tests that hold diffpure_tpu_torch against diffpure_tpu.

Inputs and weights are drawn with numpy from a seed and handed to both
packages; outputs come back as float32 numpy arrays. Weights follow
diffpure_tpu_torch.utils.weights: N(0, 1)/sqrt(fan_in) for matrices, so no
layer is switched off by a near-zero init.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# max |got - want| <= REL[dtype] * max |want|. fp32: the JAX package's own
# parity bound (docs/ARCHITECTURE.md:105-111). bf16: about one percent, for
# bf16 roundings the two sides take at different places (the TPU kernel
# keeps conv accumulators in fp32 where the references round them).
REL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(scope="module")
def two_torch_threads():
    """Two torch threads for a module's tests: the tier-1 run's xdist
    workers share the cores, and torch's default of one thread per core in
    every worker oversubscribes them (many small ops then crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def normal(rng, *shape, fan_in=None, scale=1.0, shift=0.0):
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(scale)
    if fan_in is not None:
        x /= np.float32(np.sqrt(fan_in))
    return x + np.float32(shift)


def resblock_params(rng, cin, cout, proj=True):
    """JAX-layout numpy params: (gn1s, gn1b, w0 HWIO, b0, gn2s, gn2b,
    w1 HWIO, b1, wskip (cin, cout) | None, bskip | None)."""
    return (normal(rng, cin, scale=0.1, shift=1.0), normal(rng, cin, scale=0.1),
            normal(rng, 3, 3, cin, cout, fan_in=9 * cin), normal(rng, cout, scale=0.1),
            normal(rng, cout, scale=0.1, shift=1.0), normal(rng, cout, scale=0.1),
            normal(rng, 3, 3, cout, cout, fan_in=9 * cout), normal(rng, cout, scale=0.1),
            normal(rng, cin, cout, fan_in=cin) if proj else None,
            normal(rng, cout, scale=0.1) if proj else None)


def resblock_params_torch(p):
    """JAX layout -> the port's: convs OIHW, projection (cout, cin)."""
    gn1s, gn1b, w0, b0, gn2s, gn2b, w1, b1, ws, bs = p
    t = lambda a: None if a is None else torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return (t(gn1s), t(gn1b), t(w0.transpose(3, 2, 0, 1)), t(b0), t(gn2s), t(gn2b),
            t(w1.transpose(3, 2, 0, 1)), t(b1), None if ws is None else t(ws.T), t(bs))


def attnblock_params(rng, C):
    """(gns, gnb, Wq, bq, Wk, bk, Wv, bv, Wo, bo), NIN W in (in, out)."""
    out = [normal(rng, C, scale=0.1, shift=1.0), normal(rng, C, scale=0.1)]
    for _ in range(4):
        out += [normal(rng, C, C, fan_in=C), normal(rng, C, scale=0.1)]
    return tuple(out)


def to_jax(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a).astype(dtype)


def to_torch(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_close(got, want, rel, what=""):
    got, want = np32(got), np32(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.isfinite(got).all(), what
    err = float(np.max(np.abs(got - want)))
    bound = rel * float(np.max(np.abs(want)))
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def ddpm_census(batch=2):
    """((H, C) -> GNSiLU calls, (H, C) -> attention block calls) over one
    evaluation of the full-width score_sde DDPM (models/ddpm_v1.py), walked
    on the meta device with GNSiLU and AttnBlockpp replaced by recorders of
    their input shapes."""
    from collections import Counter

    import pytest
    from diffpure_tpu_torch.models import layers
    from diffpure_tpu_torch.models.registry import create_model

    gn, attn = Counter(), Counter()

    def record(counter):
        def forward(self, x):
            counter[(x.shape[1], x.shape[3])] += 1
            return x
        return forward

    mp = pytest.MonkeyPatch()
    mp.setattr(layers.GNSiLU, "forward", record(gn))
    mp.setattr(layers.AttnBlockpp, "forward", record(attn))
    try:
        with torch.device("meta"):
            model = create_model("ddpm")
        model(torch.empty(batch, 32, 32, 3, device="meta"), torch.empty(batch, device="meta"))
    finally:
        mp.undo()
    return dict(gn), dict(attn)
