"""Plain convolution on NHWC maps with OIHW (PyTorch-layout) weights."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def conv2d_nhwc(x: Tensor, weight: Tensor, bias: Optional[Tensor] = None,
                stride: int = 1, padding: Optional[int] = None) -> Tensor:
    """Conv with symmetric padding, k//2 unless given (torch ``padding=1``
    for 3x3; 0 is VALID).

    ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is an NCHW view in
    ``channels_last`` strides, which cuDNN and oneDNN take without a copy.
    """
    pad = weight.shape[-1] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride,
                 padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()
