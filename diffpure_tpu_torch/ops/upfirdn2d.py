"""2x resampling over NHWC maps: naive, and StyleGAN2's FIR resampling
(port of diffpure_tpu/ops/upfirdn2d.py; ref
score_sde/models/up_or_down_sampling.py:31-265, score_sde/op/upfirdn2d.py).

``upfirdn2d`` has the reference's semantics: insert ``up - 1`` zeros after
each sample, pad (pad0 before, pad1 after) on both spatial axes, convolve
with the FIR kernel (a true convolution: the kernel is flipped, as JAX
flips it, :63, for XLA's correlation and as ``F.conv2d``, which also
correlates, needs it), keep every ``down``-th sample. JAX runs it as one
depthwise ``lax.conv_general_dilated`` outside any Pallas kernel; here it is
the zero insertion and ``F.pad`` around a depthwise ``F.conv2d`` (groups =
C) in the map's dtype. ``upsample_conv_2d`` is a stride-2
``F.conv_transpose2d`` with the spatially flipped weight (JAX's dilated
correlation with the unflipped HWIO weight, :136), then the FIR pass;
``conv_downsample_2d`` the FIR pass, then a stride-2 VALID ``F.conv2d``.
Conv weights are OIHW (the reference's ``Conv2d.weight``).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def naive_upsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Nearest-neighbour upsample (ref up_or_down_sampling.py:67-71)."""
    N, H, W, C = x.shape
    x = x.reshape(N, H, 1, W, 1, C).expand(N, H, factor, W, factor, C)
    return x.reshape(N, H * factor, W * factor, C)


def naive_downsample_2d(x: Tensor, factor: int = 2) -> Tensor:
    """Mean-pool downsample (ref up_or_down_sampling.py:74-77)."""
    N, H, W, C = x.shape
    x = x.reshape(N, H // factor, factor, W // factor, factor, C)
    return x.mean(dim=(2, 4))


def setup_fir_kernel(k: Union[Sequence[float], np.ndarray]) -> np.ndarray:
    """A 1-D kernel's outer product (a 2-D one as it is), normalised to sum
    1, float32 (ref up_or_down_sampling.py:189-197)."""
    k = np.asarray(k, dtype=np.float32)
    if k.ndim == 1:
        k = np.outer(k, k)
    k = k / np.sum(k)
    if k.ndim != 2 or k.shape[0] != k.shape[1]:
        raise ValueError(f"a FIR kernel is square, not {k.shape}")
    return k


def upfirdn2d(x: Tensor, kernel: Union[Tensor, np.ndarray], up: int = 1, down: int = 1,
              pad: Tuple[int, int] = (0, 0)) -> Tensor:
    """Upsample, FIR-filter and downsample (N, H, W, C) ``x`` by the
    (kh, kw) ``kernel``; output size (H up + pad0 + pad1 - kh) // down + 1."""
    N, H, W, C = x.shape
    kernel = torch.as_tensor(kernel).to(device=x.device, dtype=x.dtype)
    kh, kw = kernel.shape
    y = x.permute(0, 3, 1, 2)
    if up > 1:  # zeros after each sample
        z = y.new_zeros(N, C, H * up, W * up)
        z[:, :, ::up, ::up] = y
        y = z
    pad0, pad1 = pad
    y = F.pad(y, (pad0, pad1, pad0, pad1))
    w = torch.flip(kernel, (0, 1)).reshape(1, 1, kh, kw).expand(C, 1, kh, kw)
    y = F.conv2d(y, w, stride=down, groups=C)
    return y.permute(0, 2, 3, 1).contiguous()


def _fir(k: Optional[Sequence[float]], factor: int, gain: float) -> np.ndarray:
    if not isinstance(factor, int) or factor < 1:
        raise ValueError(f"factor must be a positive int, not {factor!r}")
    return setup_fir_kernel([1.0] * factor if k is None else k) * gain


def upsample_2d(x: Tensor, k: Optional[Sequence[float]] = None, factor: int = 2,
                gain: float = 1.0) -> Tensor:
    """FIR upsample by ``factor`` (ref up_or_down_sampling.py:203-232)."""
    kk = _fir(k, factor, gain * factor ** 2)
    p = kk.shape[0] - factor
    return upfirdn2d(x, kk, up=factor, pad=((p + 1) // 2 + factor - 1, p // 2))


def downsample_2d(x: Tensor, k: Optional[Sequence[float]] = None, factor: int = 2,
                  gain: float = 1.0) -> Tensor:
    """FIR downsample by ``factor`` (ref up_or_down_sampling.py:235-265)."""
    kk = _fir(k, factor, gain)
    p = kk.shape[0] - factor
    return upfirdn2d(x, kk, down=factor, pad=((p + 1) // 2, p // 2))


def upsample_conv_2d(x: Tensor, w: Tensor, k: Optional[Sequence[float]] = None,
                     factor: int = 2, gain: float = 1.0) -> Tensor:
    """Upsample and conv with the OIHW weight ``w`` (ref
    up_or_down_sampling.py:80-149): the transposed conv, stride
    ``factor``, then the FIR pass."""
    out_c, in_c, kh, kw = w.shape
    if kh != kw or x.shape[-1] != in_c:
        raise ValueError(f"weight {tuple(w.shape)} for a map of {x.shape[-1]} channels")
    kk = _fir(k, factor, gain * factor ** 2)
    p = (kk.shape[0] - factor) - (kw - 1)
    wt = torch.flip(w.to(x.dtype), (2, 3)).transpose(0, 1)  # (in, out, kh, kw)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=factor)
    return upfirdn2d(y.permute(0, 2, 3, 1), kk,
                     pad=((p + 1) // 2 + factor - 1, p // 2 + 1))


def conv_downsample_2d(x: Tensor, w: Tensor, k: Optional[Sequence[float]] = None,
                       factor: int = 2, gain: float = 1.0) -> Tensor:
    """FIR pass, then conv with the OIHW weight ``w`` at stride ``factor``
    (ref up_or_down_sampling.py:152-186)."""
    out_c, in_c, kh, kw = w.shape
    if kh != kw:
        raise ValueError(f"weight {tuple(w.shape)} is not square")
    kk = _fir(k, factor, gain)
    p = (kk.shape[0] - factor) + (kw - 1)
    y = upfirdn2d(x, kk, pad=((p + 1) // 2, p // 2))
    y = F.conv2d(y.permute(0, 3, 1, 2), w.to(x.dtype), stride=factor)
    return y.permute(0, 2, 3, 1).contiguous()
