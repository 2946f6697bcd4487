"""NCSN++ and DDPM layers (port of the matching parts of
diffpure_tpu/models/layers.py).

Parameter names are the reference PyTorch names (``GroupNorm_0``,
``Conv_0``, ``Dense_0``, ``NIN_0`` ...; ref score_sde/models/layerspp.py),
so a ``checkpoint_8.pth`` state dict loads as it is. Activations are NHWC.

The BigGAN and attention blocks go through the fused-block wrappers,
which run the plain version on CPU tensors and the CUDA kernels on CUDA
tensors. That is the JAX gate of layers.py:516-539, the activation fixed
to swish: a BigGAN block that resamples with the FIR filter (``fir`` with
``up`` or ``down``) or has no temb (an unconditional NCSN++) runs JAX's
unfused graph in plain PyTorch on either device (``_forward_plain``), as
JAX runs it outside its kernels (:518-520). In training mode
(``train=True``) with a dropout rate above 0 a residual block takes the
same unfused graph, with dropout drawn from the caller's generator, as
JAX's gate ``deterministic`` sends it to its unfused path (the kernels
have no dropout). At rate 0 dropout is the identity and the kernels compute the
same function, so training mode keeps them. The TPU's 128-lane condition
does not apply on the GPU. They are
differentiable with respect to their inputs (the attack path): the
wrappers are autograd Functions whose backward is the
CUDA backward kernel for the residual blocks and autograd of the plain
version for the attention block, as in JAX. Weight gradients, when asked
for, come from autograd of the plain version.

The DDPM++ residual block (``ResnetBlockDDPMpp``) and the standalone
``UpsampleLayer`` / ``DownsampleLayer`` are plain tensor code around
``GNSiLU``, whose CUDA kernel (``ops/groupnorm.group_norm_silu_fused``)
takes its gradient from autograd of the plain chain, as JAX does. So are
NCSN++'s other options (JAX :249-420): ``GaussianFourierProjection``,
``Combine``, ``FIRConv2d`` and the FIR resampling of ops/upfirdn2d.py.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.init import ddpm_init_
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.fused_attnblock import fused_attnblock, \
    pack_attnblock_params
from diffpure_tpu_torch.ops.fused_resblock import fused_resblock, \
    fused_resblock_cat, pack_resblock_bwd_params, pack_resblock_params
from diffpure_tpu_torch.ops.groupnorm import group_norm, group_norm_silu, \
    group_norm_silu_fused, ncsn_num_groups
from diffpure_tpu_torch.ops.upfirdn2d import conv_downsample_2d, downsample_2d, \
    naive_downsample_2d, naive_upsample_2d, upsample_2d, upsample_conv_2d

Tensor = torch.Tensor

INV_SQRT2 = 1.0 / math.sqrt(2.0)
FIR_KERNEL = (1, 3, 3, 1)


def dropout(x: Tensor, rate: float, generator: Optional[torch.Generator]) -> Tensor:
    """flax ``nn.Dropout``: the identity at rate 0, else x / keep where a
    uniform draw falls below keep = 1 - rate, 0 elsewhere. The draw is
    made on the generator's device."""
    if rate == 0.0:
        return x
    keep = 1.0 - rate
    dev = generator.device if generator is not None else x.device
    mask = torch.rand(x.shape, generator=generator, device=dev).to(x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def get_timestep_embedding(timesteps: Tensor, embedding_dim: int,
                           max_positions: int = 10000) -> Tensor:
    """DDPM sinusoidal embedding [sin, cos] with frequency factor
    1/(half-1), in fp32 (ref score_sde/models/layers.py:515-532)."""
    assert timesteps.ndim == 1
    half_dim = embedding_dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32,
                                 device=timesteps.device) * -emb)
    emb = timesteps.float()[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if embedding_dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def adm_timestep_embedding(timesteps: Tensor, dim: int,
                           max_period: int = 10000) -> Tensor:
    """ADM sinusoidal embedding [cos, sin] with frequency factor 1/half, in
    fp32 (port of diffpure_tpu/models/layers.py:117; ref
    guided_diffusion/nn.py:110-128): another order and denominator than
    NCSN++'s ``get_timestep_embedding``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class NIN(nn.Module):
    """1x1 'network-in-network' with the reference's (in, out) weight ``W``
    (ref score_sde/models/layers.py:546-556)."""

    def __init__(self, in_dim: int, num_units: int):
        super().__init__()
        bound = 1.0 / math.sqrt(in_dim)
        self.W = nn.Parameter(torch.empty(in_dim, num_units).uniform_(-bound, bound))
        self.b = nn.Parameter(torch.zeros(num_units))

    def forward(self, x: Tensor) -> Tensor:
        return x @ self.W.to(x.dtype) + self.b.to(x.dtype)


def _stamp(t: Tensor):
    """Changes when t is replaced or written in place. Tensors made under
    inference_mode (e.g. by a .to() there) keep no version counter; for
    them only a replacement is seen."""
    return t.data_ptr(), None if t.is_inference() else t._version


class _Derived:
    """Something made from a block's weights for one dtype and device (the
    kernel-layout pack, a cast), remade only when the dtype, the device or a
    weight changes: one purification makes thousands of block calls with the
    same weights."""

    def __init__(self, make):
        self._make = make
        self._key = None
        self._value = None

    def get(self, tensors, dtype: torch.dtype, device: torch.device):
        key = (dtype, device, tuple(_stamp(t) for t in tensors if t is not None))
        if key != self._key:
            self._value = self._make(tensors, dtype, device)
            self._key = key
        return self._value


def _cast(tensors, dtype, device):
    return tuple(t.to(device=device, dtype=dtype) for t in tensors)


def _cast_cached(cache: _Derived, tensors, dtype, device):
    """The tensors in dtype on device, from ``cache`` unless autograd needs
    the cast (a cast of weights that require grad is a graph node)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _cast(tensors, dtype, device)
    return cache.get(tensors, dtype, device)


class GroupNormTorch(nn.GroupNorm):
    """GroupNorm over NHWC maps with fp32 statistics, its scale and bias
    rounded to the map's dtype first (layers.py:135)."""

    def forward(self, x: Tensor) -> Tensor:
        return group_norm(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                          self.num_groups, self.eps)


class GNSiLU(nn.GroupNorm):
    """GroupNorm + SiLU with GroupNormTorch's parameters (layers.py:71).

    On a CPU tensor the plain ``group_norm_silu`` (JAX's default path: the
    GroupNorm is cast to the map's dtype before the SiLU); on a CUDA tensor
    kernel #10, ``group_norm_silu_fused`` (one rounding, as JAX's Pallas
    path). JAX's gates of that path, ``set_fused_gn_silu`` and the map
    fitting VMEM, are dropped: the port has no global kernel switches
    (ROADMAP item 3), and the kernel takes every map size.
    """

    def forward(self, x: Tensor) -> Tensor:
        fn = group_norm_silu if x.device.type == "cpu" else group_norm_silu_fused
        return fn(x, self.weight, self.bias, self.num_groups, self.eps)


class AttnBlockpp(nn.Module):
    """NCSN++ self-attention block over spatial positions
    (ref layerspp.py:62-91)."""

    def __init__(self, channels: int, skip_rescale: bool = False):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(ncsn_num_groups(channels), channels,
                                        eps=1e-6)
        self.NIN_0 = NIN(channels, channels)
        self.NIN_1 = NIN(channels, channels)
        self.NIN_2 = NIN(channels, channels)
        self.NIN_3 = NIN(channels, channels)
        self.skip_rescale = skip_rescale
        self._kernel = _Derived(pack_attnblock_params)

    def _params(self):
        gn = self.GroupNorm_0
        return (gn.weight, gn.bias, self.NIN_0.W, self.NIN_0.b, self.NIN_1.W,
                self.NIN_1.b, self.NIN_2.W, self.NIN_2.b, self.NIN_3.W,
                self.NIN_3.b)

    def forward(self, x: Tensor) -> Tensor:
        params = self._params()
        packed = (self._kernel.get(params, x.dtype, x.device)
                  if x.device.type == "cuda" else None)
        return fused_attnblock(
            x, params, num_groups=self.GroupNorm_0.num_groups, eps=1e-6,
            rescale=self.skip_rescale, packed=packed)


def _rescale(y: Tensor) -> Tensor:
    """y / sqrt(2) as JAX's weakly typed constant gives it: the constant
    rounded to y's dtype first."""
    return y * torch.tensor(INV_SQRT2, dtype=y.dtype)


class ResnetBlockBigGANpp(nn.Module):
    """BigGAN residual block with optional 2x resampling, naive or FIR
    (ref layerspp.py:212-274). ``temb_dim=None``: no ``Dense_0`` (an
    unconditional NCSN++)."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = 512, up: bool = False, down: bool = False,
                 skip_rescale: bool = True, dropout: float = 0.1, fir: bool = False,
                 fir_kernel: Tuple[int, ...] = FIR_KERNEL):
        super().__init__()
        out_ch = out_ch or in_ch
        self.dropout = dropout
        self.GroupNorm_0 = nn.GroupNorm(ncsn_num_groups(in_ch), in_ch, eps=1e-6)
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.Dense_0 = nn.Linear(temb_dim, out_ch)
        self.GroupNorm_1 = nn.GroupNorm(ncsn_num_groups(out_ch), out_ch, eps=1e-6)
        self.Conv_1 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.has_proj = in_ch != out_ch or up or down
        if self.has_proj:
            self.Conv_2 = nn.Conv2d(in_ch, out_ch, 1)
        self.resample = "up" if up else ("down" if down else "none")
        self.fir_kernel = tuple(fir_kernel) if fir else None
        # JAX's gate (layers.py:518-520): FIR resampling, or no temb, runs
        # the unfused graph
        self.plain = (fir and (up or down)) or temb_dim is None
        self.skip_rescale = skip_rescale
        self._kernel = _Derived(pack_resblock_params)
        self._kernel_bwd = _Derived(pack_resblock_bwd_params)
        self._dense = _Derived(_cast)

    def _params(self):
        proj = self.Conv_2 if self.has_proj else None
        return (self.GroupNorm_0.weight, self.GroupNorm_0.bias,
                self.Conv_0.weight, self.Conv_0.bias,
                self.GroupNorm_1.weight, self.GroupNorm_1.bias,
                self.Conv_1.weight, self.Conv_1.bias,
                proj.weight[:, :, 0, 0] if proj is not None else None,
                proj.bias if proj is not None else None)

    def _forward_plain(self, x: Tensor, temb: Optional[Tensor], train: bool,
                       generator: Optional[torch.Generator]) -> Tensor:
        """JAX's unfused block (layers.py:541-568), rounding where it
        rounds: each GroupNorm's scale and bias in the map's dtype, swish,
        the resampling, then the convs and the Dense in the torso's dtype
        (temb's; without a temb, x's), each conv's bias added after it."""
        cdt = temb.dtype if temb is not None else x.dtype

        def gn_silu(gn, h):
            return group_norm_silu(h, gn.weight.to(h.dtype), gn.bias.to(h.dtype),
                                   gn.num_groups, gn.eps)

        def conv(c, h):
            return conv_then_bias(h.to(cdt), c.weight.to(cdt), c.bias.to(cdt))

        h = gn_silu(self.GroupNorm_0, x)
        if self.resample != "none":
            if self.fir_kernel is not None:
                fn = upsample_2d if self.resample == "up" else downsample_2d
                h, x = fn(h, self.fir_kernel, factor=2), fn(x, self.fir_kernel, factor=2)
            else:
                fn = naive_upsample_2d if self.resample == "up" else naive_downsample_2d
                h, x = fn(h), fn(x)
        h = conv(self.Conv_0, h)
        if temb is not None:
            d = self.Dense_0
            h = h + (F.linear(F.silu(temb).to(cdt), d.weight.to(cdt))
                     + d.bias.to(cdt))[:, None, None, :]
        h = gn_silu(self.GroupNorm_1, h)
        if train:
            h = dropout(h, self.dropout, generator)
        h = conv(self.Conv_1, h)
        if self.has_proj:
            x = conv(self.Conv_2, x)
        return _rescale(x + h) if self.skip_rescale else x + h

    def forward(self, x: Union[Tensor, Tuple[Tensor, Tensor]],
                temb: Optional[Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: an NHWC map, or the up path's (h, skip) pair, which is
        concatenated along channels (inside the kernel when the block
        projects and does not resample). ``train`` with a dropout rate
        above 0: the unfused graph with dropout from ``generator``."""
        if self.plain or (train and self.dropout > 0):
            if isinstance(x, tuple):
                x = torch.cat(x, dim=-1)
            return self._forward_plain(x, temb, train, generator)
        # the temb row stays a plain op, in the torso's dtype (DenseP)
        w, b = _cast_cached(self._dense, (self.Dense_0.weight, self.Dense_0.bias),
                            temb.dtype, temb.device)
        temb_row = F.linear(F.silu(temb), w, b)
        params = self._params()
        anchor = x[0] if isinstance(x, tuple) else x
        on_card = anchor.device.type == "cuda"
        kw = dict(num_groups1=self.GroupNorm_0.num_groups,
                  num_groups2=self.GroupNorm_1.num_groups, eps=1e-6,
                  rescale=self.skip_rescale,
                  packed=self._kernel.get(params, anchor.dtype, anchor.device)
                  if on_card else None,
                  packed_bwd=self._kernel_bwd.get(params, anchor.dtype, anchor.device)
                  if on_card and torch.is_grad_enabled() else None)
        if isinstance(x, tuple):
            if self.has_proj and self.resample == "none":
                return fused_resblock_cat(x[0], x[1], temb_row, params, **kw)
            x = torch.cat(x, dim=-1)
        return fused_resblock(x, temb_row, params, resample=self.resample, **kw)


class ResnetBlockDDPMpp(nn.Module):
    """DDPM-style residual block (layers.py:423-462; ref layerspp.py:166-209);
    dropout acts in training mode only (``train``, drawn from ``generator``).

    The convs and ``Dense_0`` compute in the torso's dtype, which is temb's:
    NCSN++ casts temb to its ``dtype`` as JAX does, and without one flax
    promotes against the fp32 parameters, which is temb's fp32. The NIN skip
    keeps x's dtype, and ``x + h`` promotes, as in JAX.
    """

    def __init__(self, in_ch: int, out_ch: Optional[int] = None,
                 temb_dim: Optional[int] = None, conv_shortcut: bool = False,
                 skip_rescale: bool = False, dropout: float = 0.1):
        super().__init__()
        out_ch = out_ch or in_ch
        self.dropout = dropout
        self.GroupNorm_0 = GNSiLU(ncsn_num_groups(in_ch), in_ch, eps=1e-6)
        self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        if temb_dim is not None:
            self.Dense_0 = nn.Linear(temb_dim, out_ch)
        self.GroupNorm_1 = GNSiLU(ncsn_num_groups(out_ch), out_ch, eps=1e-6)
        self.Conv_1 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        # the skip: identity, Conv_2 (3x3) or NIN_0 (1x1)
        self.skip = None if in_ch == out_ch else ("conv" if conv_shortcut else "nin")
        if self.skip == "conv":
            self.Conv_2 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        elif self.skip == "nin":
            self.NIN_0 = NIN(in_ch, out_ch)
        self.skip_rescale = skip_rescale
        self._weights = _Derived(_cast)

    def forward(self, x: Union[Tensor, Tuple[Tensor, Tensor]],
                temb: Optional[Tensor] = None, train: bool = False,
                generator: Optional[torch.Generator] = None) -> Tensor:
        """x: an NHWC map, or the up path's (h, skip) pair, concatenated."""
        if isinstance(x, tuple):
            x = torch.cat(x, dim=-1)
        cdt = temb.dtype if temb is not None else torch.promote_types(x.dtype, torch.float32)
        convs = [self.Conv_0, self.Conv_1] + ([self.Conv_2] if self.skip == "conv" else [])
        tensors = [t for c in convs for t in (c.weight, c.bias)]
        if temb is not None:
            tensors += [self.Dense_0.weight, self.Dense_0.bias]
        w = _cast_cached(self._weights, tensors, cdt, x.device)
        h = conv2d_nhwc(self.GroupNorm_0(x).to(cdt), *w[0:2])
        if temb is not None:
            h = h + F.linear(F.silu(temb), *w[-2:])[:, None, None, :]
        h = self.GroupNorm_1(h)
        if train:
            h = dropout(h, self.dropout, generator)
        h = conv2d_nhwc(h.to(cdt), *w[2:4])
        if self.skip == "conv":
            x = conv2d_nhwc(x.to(cdt), *w[4:6])
        elif self.skip == "nin":
            x = self.NIN_0(x)
        return x + h if not self.skip_rescale else (x + h) * INV_SQRT2


class GaussianFourierProjection(nn.Module):
    """Gaussian Fourier features of the noise level (layers.py:249; ref
    layerspp.py:32-41): [sin, cos](2 pi x W). ``W`` is a fixed random
    projection: no gradient, kept in the state dict."""

    def __init__(self, embedding_size: int = 256, scale: float = 1.0):
        super().__init__()
        self.scale = scale
        self.W = nn.Parameter(torch.randn(embedding_size) * scale, requires_grad=False)

    def forward(self, x: Tensor) -> Tensor:
        x_proj = x[:, None] * self.W[None, :] * 2 * math.pi
        return torch.cat([torch.sin(x_proj), torch.cos(x_proj)], dim=-1)


def conv_then_bias(x: Tensor, w: Tensor, b: Tensor, stride: int = 1,
                   padding: Optional[int] = None) -> Tensor:
    """flax ``nn.Conv``'s rounding: the conv's output in x's dtype, then the
    bias. In fp32 the bias rides in the conv's own call (one fp32 add
    either way, and one launch fewer); in a narrower dtype it is added
    after the output is rounded, as in JAX."""
    if x.dtype == torch.float32:
        return conv2d_nhwc(x, w, b, stride=stride, padding=padding)
    return conv2d_nhwc(x, w, stride=stride, padding=padding) + b


def _conv_promoted(c: nn.Conv2d, x: Tensor, stride: int = 1,
                   padding: Optional[int] = None) -> Tensor:
    """flax ``nn.Conv`` without a dtype: the conv in the promotion of x's
    dtype and the fp32 parameters, then the bias."""
    cdt = torch.promote_types(x.dtype, c.weight.dtype)
    return conv_then_bias(x.to(cdt), c.weight.to(cdt), c.bias.to(cdt),
                          stride=stride, padding=padding)


class Combine(nn.Module):
    """A pyramid input combined with the trunk (layers.py:268; ref
    layerspp.py:44-59): ``Conv_0`` (1x1, promoted dtype) of x, then
    concatenated with y (``'cat'``) or added to it (``'sum'``)."""

    def __init__(self, dim1: int, dim2: int, method: str = "cat"):
        super().__init__()
        if method not in ("cat", "sum"):
            raise ValueError(f"combine method {method!r}")
        self.Conv_0 = nn.Conv2d(dim1, dim2, 1)
        self.method = method

    def forward(self, x: Tensor, y: Tensor) -> Tensor:
        h = _conv_promoted(self.Conv_0, x)
        if self.method == "cat":
            dt = torch.promote_types(h.dtype, y.dtype)
            return torch.cat([h.to(dt), y.to(dt)], dim=-1)
        return h + y


class FIRConv2d(nn.Module):
    """StyleGAN2's conv with fused FIR up- or downsampling (layers.py:334;
    ref up_or_down_sampling.py:31-64), in x's dtype; ``weight`` OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, up: bool = False,
                 down: bool = False, resample_kernel: Tuple[int, ...] = FIR_KERNEL,
                 use_bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(ddpm_init_(torch.empty(out_ch, in_ch, kernel, kernel),
                                              None))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        self.up, self.down = up, down
        self.resample_kernel = tuple(resample_kernel)

    def forward(self, x: Tensor) -> Tensor:
        w = self.weight.to(x.dtype)
        if self.up:
            x = upsample_conv_2d(x, w, k=self.resample_kernel)
        elif self.down:
            x = conv_downsample_2d(x, w, k=self.resample_kernel)
        else:
            x = conv2d_nhwc(x, w)
        if self.bias is not None:
            x = x + self.bias.to(x.dtype)
        return x


class UpsampleLayer(nn.Module):
    """NCSN++ Upsample (layers.py:369-392). Without FIR: nearest 2x, then
    ``Conv_0`` with ``with_conv``; the conv has no dtype of its own, so it
    computes in the promotion of x's dtype and its fp32 parameters, as
    flax's ``nn.Conv(dtype=None)``. With FIR: ``upsample_2d``, or
    ``Conv2d_0`` (``FIRConv2d``, in x's dtype) with ``with_conv``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Tuple[int, ...] = FIR_KERNEL):
        super().__init__()
        out_ch = out_ch or in_ch
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, up=True, resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)

    def forward(self, x: Tensor) -> Tensor:
        if self.fir:
            return self.Conv2d_0(x) if self.with_conv else upsample_2d(x, self.fir_kernel)
        h = naive_upsample_2d(x)
        if not self.with_conv:
            return h
        c = self.Conv_0
        cdt = torch.promote_types(x.dtype, c.weight.dtype)
        return conv2d_nhwc(h.to(cdt), c.weight.to(cdt), c.bias.to(cdt))


class DownsampleLayer(nn.Module):
    """NCSN++ Downsample (layers.py:394-420). Without FIR: with
    ``with_conv`` the asymmetric pad (bottom and right by one), then
    ``Conv_0`` stride 2 VALID, in the promoted dtype as
    ``UpsampleLayer``'s; else a 2x2 mean. With FIR: ``downsample_2d``, or
    ``Conv2d_0`` (``FIRConv2d``) with ``with_conv``."""

    def __init__(self, in_ch: int, out_ch: Optional[int] = None, with_conv: bool = False,
                 fir: bool = False, fir_kernel: Tuple[int, ...] = FIR_KERNEL):
        super().__init__()
        out_ch = out_ch or in_ch
        if with_conv and fir:
            self.Conv2d_0 = FIRConv2d(in_ch, out_ch, down=True, resample_kernel=fir_kernel)
        elif with_conv:
            self.Conv_0 = nn.Conv2d(in_ch, out_ch, 3, stride=2)
        self.with_conv, self.fir, self.fir_kernel = with_conv, fir, tuple(fir_kernel)

    def forward(self, x: Tensor) -> Tensor:
        if self.fir:
            return self.Conv2d_0(x) if self.with_conv else downsample_2d(x, self.fir_kernel)
        if not self.with_conv:
            return naive_downsample_2d(x)
        c = self.Conv_0
        cdt = torch.promote_types(x.dtype, c.weight.dtype)
        # NHWC: F.pad lists the last axis first -> (C), (W: right 1), (H: bottom 1)
        x = F.pad(x, (0, 0, 0, 1, 0, 1)).to(cdt)
        return conv2d_nhwc(x, c.weight.to(cdt), c.bias.to(cdt), stride=2, padding=0)
