"""Flash (online-softmax) attention for the ADM's 1024-token blocks (port of
diffpure_tpu/ops/flash_attention.py).

``flash_attention`` launches the CUDA kernel in ``csrc/flash_attention.cu``
(replacing ``_flash_forward``, :145) on CUDA tensors and runs its plain
version ``_reference_attention`` (:88, exact softmax, fp32 throughout) on
CPU tensors. q, k, v are (BH, T, D); ``scale`` applies to both q and k (the
ADM ch^-1/4 convention). The kernel is built for the head widths
FLASH_WIDTHS (32, 64, 128, 256; the ADM-256 has 64); any other D up to 256
runs on the kernel of the next of them. In bf16 with D % 8 == 0 it reads
the (BH, T, D) tensors as they are (its tensor maps give zeros for the
channels past D) and writes D channels; otherwise (fp32, or another D) the
wrapper zero-pads q, k and v to the width (``pad_heads``) and slices the
output back. Either way the zero channels add exactly 0 to every fp32
score, and the scale is passed on its own, so it does not depend on the
width. T must be a multiple of the kernel's
query block (128 bf16, 64 fp32); D > 256 or another T raises before any
launch.

Gradients, as JAX's ``custom_vjp`` (:101-142): ``flash_attention`` is an
autograd ``Function`` (``_cuda.KernelFunction``) that saves q, k and v and
whose backward is the dense VJP of ``_reference_attention`` (autograd,
recomputed), over slabs of the largest divisor of B*heads up to 32
(``_largest_divisor_leq``, :113-139), so that the transient (slab, T, T)
scores stay bounded. The gradients have the caller's head width D: the
zero padding is the forward's business only.
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
FLASH_WIDTHS = (32, 64, 128, 256)


def check_flash_shape(dtype: torch.dtype, T: int, D: int) -> int:
    """Raise on what the kernel does not take: D from 1 to 256, and T a
    multiple of its query block (128 bf16, 64 fp32). Returns the width the
    kernel runs D at (flash_width)."""
    block = 128 if dtype == torch.bfloat16 else 64
    if not 1 <= D <= FLASH_WIDTHS[-1] or T % block:
        raise ValueError(f"the flash kernel takes 1 <= D <= {FLASH_WIDTHS[-1]} and "
                         f"T % {block} == 0 ({dtype}); got T={T}, D={D}")
    return flash_width(D)


def flash_width(D: int) -> int:
    """The least width of FLASH_WIDTHS that holds D channels."""
    return next(w for w in FLASH_WIDTHS if w >= D)


def operand_width(dtype: torch.dtype, D: int) -> int:
    """The width q, k, v and the output hold at the launch: D where the
    kernel reads the heads as they are (D a built width, or bf16 with D % 8
    == 0: its tensor maps give zeros past D), else flash_width(D), to which
    the wrapper zero-pads them."""
    width = flash_width(D)
    return D if width == D or (dtype == torch.bfloat16 and D % 8 == 0) else width


def pad_heads(t: Tensor, width: int) -> Tensor:
    """(BH, T, D) zero-padded along D to ``width`` channels (t itself when D
    is the width)."""
    D = t.shape[-1]
    return t if D == width else torch.nn.functional.pad(t, (0, width - D))


def _flash_kernel(scale, q, k, v):
    dev, dtype = q.device, q.dtype
    if dtype not in _cuda.DTYPE_CODE or q.ndim != 3:
        raise ValueError(f"flash_attention takes (BH, T, D) fp32 or bf16, not "
                         f"{dtype} {tuple(q.shape)}")
    BH, T, D = q.shape
    width = check_flash_shape(dtype, T, D)
    for t, n in ((q, "q"), (k, "k"), (v, "v")):
        _cuda.check_operand(t, n, dev, dtype, (BH, T, D))
    dt = operand_width(dtype, D)
    qkv = [pad_heads(t, dt) for t in (q, k, v)]  # held until the launch is queued
    ptrs = [t.data_ptr() for t in qkv]
    out = torch.empty((BH, T, dt), device=dev, dtype=dtype)
    err = _cuda.lib().diffpure_flash_attention(
        _cuda.DTYPE_CODE[dtype], *ptrs, BH, T, width, dt, float(scale) ** 2,
        out.data_ptr(), _cuda.stream(dev))
    _cuda.check(err, "flash_attention kernel")
    flash_attention.launches += 1
    return out if dt == D else out[..., :D].contiguous()


def _flash_plain(scale, q, k, v):
    return _reference_attention(q, k, v, scale)


# JAX's slab of the backward: at most this many (batch, head) pairs a VJP
BWD_SLAB = 32


def largest_divisor_leq(n: int, cap: int) -> int:
    """The largest divisor of n that is at most cap (JAX :113)."""
    return next(c for c in range(min(n, cap), 0, -1) if n % c == 0)


_dense_vjp = _cuda.autograd_vjp(_flash_plain)


def _flash_vjp(scale, need, tensors, grads):
    BH = tensors[0].shape[0]
    slab = largest_divisor_leq(BH, BWD_SLAB)
    parts = [_dense_vjp(scale, need, [t[i:i + slab] for t in tensors],
                        [g[i:i + slab] for g in grads]) for i in range(0, BH, slab)]
    return tuple(torch.cat([p[j] for p in parts]) if n else None
                 for j, n in enumerate(need))


_FLASH = (_flash_kernel, _flash_plain, _flash_vjp)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """softmax(q k^T scale^2) v without the T x T scores: plain on CPU, the
    CUDA kernel on CUDA; differentiable (the dense VJP, slab by slab)."""
    _cuda.check_device("flash_attention", q)
    return _cuda.KernelFunction.apply(_FLASH, float(scale), q, k, v)


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
