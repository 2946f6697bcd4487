"""Flash (online-softmax) attention for the ADM's 1024-token blocks (port of
diffpure_tpu/ops/flash_attention.py).

``flash_attention`` launches the CUDA kernel in ``csrc/flash_attention.cu``
(replacing ``_flash_forward``, :145) on CUDA tensors and runs its plain
version ``_reference_attention`` (:88, exact softmax, fp32 throughout) on
CPU tensors. q, k, v are (BH, T, D); ``scale`` applies to both q and k (the
ADM ch^-1/4 convention). The kernel takes head widths D in FLASH_WIDTHS
(32, 64, 128; the ADM-256 has 64) and T a multiple of its query block (128
bf16, 64 fp32), and raises on others before any launch (JAX's kernel takes
any D: the other widths are an open gap, ROADMAP). Forward only on the card: JAX's
backward is a dense VJP of the reference (:101-142); here the wrapper
raises if autograd would need it on a CUDA tensor (ROADMAP).
"""
from __future__ import annotations

import torch

from diffpure_tpu_torch.ops import _cuda

Tensor = torch.Tensor


def _reference_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """softmax((q scale)(k scale)^T) v in fp32, cast to q's dtype."""
    qf, kf = q.float() * scale, k.float() * scale
    p = torch.softmax(torch.einsum("btd,bsd->bts", qf, kf), dim=-1)
    return torch.einsum("bts,bsd->btd", p, v.float()).to(q.dtype)


# The head widths the kernel is built for (csrc/flash_attention.cu).
FLASH_WIDTHS = (32, 64, 128)


def check_flash_shape(dtype: torch.dtype, T: int, D: int) -> None:
    """Raise on what the kernel does not take: D in FLASH_WIDTHS, and T a
    multiple of its query block (128 bf16, 64 fp32)."""
    block = 128 if dtype == torch.bfloat16 else 64
    if D not in FLASH_WIDTHS or T % block:
        raise ValueError(f"the flash kernel takes D in {FLASH_WIDTHS} and T % {block} == 0 "
                         f"({dtype}); got T={T}, D={D}")


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """softmax(q k^T scale^2) v without the T x T scores: plain on CPU, the
    CUDA kernel on CUDA."""
    if q.device.type == "cpu":
        return _reference_attention(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    _cuda.refuse_card_grad("flash_attention", q, k, v)
    dev, dtype = q.device, q.dtype
    if dtype not in _cuda.DTYPE_CODE or q.ndim != 3:
        raise ValueError(f"flash_attention takes (BH, T, D) fp32 or bf16, not "
                         f"{dtype} {tuple(q.shape)}")
    BH, T, D = q.shape
    check_flash_shape(dtype, T, D)
    ptrs = [_cuda.check_operand(t, n, dev, dtype, (BH, T, D))
            for t, n in ((q, "q"), (k, "k"), (v, "v"))]
    out = torch.empty_like(q)
    err = _cuda.lib().diffpure_flash_attention(
        _cuda.DTYPE_CODE[dtype], *ptrs, BH, T, D, float(scale) ** 2,
        out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "flash_attention kernel")
    flash_attention.launches += 1
    return out


def qkv_flash_attention(qkv: Tensor, n_heads: int, order: str = "legacy") -> Tensor:
    """Drop-in for ops.attention.qkv_attention through ``flash_attention``.
    qkv: (B, T, 3 * heads * ch) packed as in the ADM checkpoints."""
    B, T, width = qkv.shape
    ch = width // (3 * n_heads)
    if order == "legacy":
        q, k, v = qkv.reshape(B, T, n_heads, 3 * ch).split(ch, dim=-1)
    elif order == "new":
        r = qkv.reshape(B, T, 3, n_heads, ch)
        q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    else:
        raise ValueError(order)

    def to_bh(t):  # (B, T, heads, ch) -> (B * heads, T, ch)
        return t.permute(0, 2, 1, 3).reshape(B * n_heads, T, ch).contiguous()

    out = flash_attention(to_bh(q), to_bh(k), to_bh(v), 1.0 / ch ** 0.25)
    return out.reshape(B, n_heads, T, ch).permute(0, 2, 1, 3).reshape(
        B, T, n_heads * ch)


# Kernel launches since the last reset (plain CPU calls do not count).
flash_attention.launches = 0
