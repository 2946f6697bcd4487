"""Operations and bytes of a score UNet's blocks, whatever runs them: a
residual block (GroupNorm, SiLU, conv3x3, the time embedding's scale or
bias, GroupNorm, SiLU, conv3x3, the skip: identity or a 1x1 projection;
resampled to the output size before the first conv), its backward, and a
self-attention block (GroupNorm, q k v, softmax(q k^T) v, the output
projection). The convs' and projections' multiply-adds, twice
(GroupNorm and the elementwise work are < 1% of them); each input read
once and each output written once, weights in the compute dtype, GroupNorm
affines and biases in fp32, backward outputs in fp32. So a block's least
time is the same whether one fused kernel, several, or a library runs it.

A family's ``census(args)`` walks its reference on the meta device and
returns ``(kind, resample, H, cin, cout, proj) -> calls`` of one
evaluation; its ``KERNELS`` name the program's hand-written kernels by
fragments of the names the profiler reports."""
from __future__ import annotations

from typing import Dict, Tuple

from gpubench.counts.peaks import ESIZE, bound_s

Key = Tuple[str, str, int, int, int, bool]


def block_cost(name: str, rs: str, H: int, cin: int, cout: int, proj: bool, n: int,
               esize: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call at batch n; ``name`` is "resblock",
    "resblock_bwd" or "attnblock"."""
    Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
    m_in, m_out = n * H * H, n * Ho * Ho
    if name == "attnblock":  # qkv, q k^T, p v, out
        flops = 2 * m_in * 4 * cin * cin + 2 * 2 * n * (H * H) ** 2 * cin
        return flops, 2 * m_in * cin * esize + 4 * cin * cin * esize + 10 * cin * 4
    w = 9 * cin * cout + 9 * cout * cout + (cin * cout if proj else 0)
    vecs = (2 * cin + 4 * cout) * 4
    if name == "resblock_bwd":  # recompute conv0, conv1^T, conv0^T, skip adjoint
        flops = 2 * m_out * (w + 9 * cin * cout)
        nbytes = (m_in * cin + n * cout + m_out * cout + w) * esize + vecs \
            + (m_in * cin + n * cout) * 4
        return flops, nbytes
    return 2 * m_out * w, (m_in * cin + n * cout + m_out * cout + w) * esize + vecs


def step_bound_s(census: Dict[Key, int], n: int, dtype: str, forwards: int,
                 backwards: int) -> float:
    """Least time of a solver step's blocks: ``forwards`` evaluations and
    ``backwards`` backward passes of the residual blocks at batch n (the
    attention blocks' backward is not counted)."""
    total, e = 0.0, ESIZE[dtype]
    for (kind, rs, H, cin, cout, proj), calls in census.items():
        total += forwards * calls * bound_s(*block_cost(kind, rs, H, cin, cout, proj, n, e),
                                            dtype)
        if kind == "resblock":
            total += backwards * calls * bound_s(
                *block_cost("resblock_bwd", rs, H, cin, cout, proj, n, e), dtype)
    return total
