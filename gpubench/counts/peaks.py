"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, no sparsity). fp32 is the FMA units' rate: the configurations
that state fp32 run with TF32 off."""
from __future__ import annotations

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"bfloat16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time a call can take: operations over the peak or bytes
    over the HBM rate, whichever is longer."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
