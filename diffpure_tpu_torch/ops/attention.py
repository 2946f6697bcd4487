"""Single-head spatial self-attention over NHWC maps (port of
diffpure_tpu/ops/attention.py:34)."""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def spatial_attention(q: Tensor, k: Tensor, v: Tensor) -> Tensor:
    """w[b,p,p'] = softmax_p'(<q_bp, k_bp'> * C^-0.5); out = w @ v.

    Products accumulate in fp32; the scores round to the input dtype before
    the fp32 softmax, as in the JAX op.
    """
    N, H, W, C = q.shape
    q2, k2, v2 = (t.reshape(N, H * W, C).float() for t in (q, k, v))
    w = torch.bmm(q2, k2.transpose(1, 2)) * (int(C) ** (-0.5))
    w = torch.softmax(w.to(q.dtype).float(), dim=-1).to(q.dtype)
    out = torch.bmm(w.float(), v2)
    return out.to(q.dtype).reshape(N, H, W, C)
