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


def qkv_attention(qkv: Tensor, n_heads: int, order: str = "legacy") -> Tensor:
    """Multi-head attention on a packed qkv tensor (port of
    diffpure_tpu/ops/attention.py:52).

    qkv: (B, T, 3 * n_heads * ch). 'legacy' is heads-major, [h0 q, k, v |
    h1 q, k, v | ...]; 'new' is [q all heads | k | v]. q and k are each
    scaled by ch^-1/4 (itself rounded to qkv's dtype) in qkv's dtype; the logits round to that dtype before
    the fp32 softmax, and the probabilities round again, as in JAX.
    Returns (B, T, n_heads * ch).
    """
    B, T, width = qkv.shape
    if width % (3 * n_heads):
        raise ValueError(f"width {width} does not split into 3 x {n_heads} heads")
    ch = width // (3 * n_heads)
    if order == "legacy":
        q, k, v = qkv.reshape(B, T, n_heads, 3 * ch).split(ch, dim=-1)
    elif order == "new":
        r = qkv.reshape(B, T, 3, n_heads, ch)
        q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    else:
        raise ValueError(order)
    dtype = qkv.dtype
    # a Python scale enters JAX's product weakly typed: rounded to qkv's dtype
    scale = torch.tensor(1.0 / ch ** 0.25, dtype=dtype, device=qkv.device)
    w = torch.einsum("bthc,bshc->bhts", (q * scale).float(),
                     (k * scale).float()).to(dtype)
    w = torch.softmax(w.float(), dim=-1).to(dtype)
    a = torch.einsum("bhts,bshc->bthc", w.float(), v.float()).to(dtype)
    return a.reshape(B, T, n_heads * ch)
