"""ADM (guided-diffusion) UNet over NHWC maps (port of
diffpure_tpu/models/adm_unet.py; ref guided_diffusion/unet.py:404-671).

Module and parameter names are guided-diffusion's own
(``input_blocks.4.0.in_layers.0.weight``, ``qkv`` and ``proj_out`` as conv1d
weights (out, in, 1), ``emb_layers.1`` a Linear), so a real
``256x256_diffusion_uncond.pt`` loads with ``load_state_dict(strict=True)``
and ``translate_adm`` maps this state dict to the JAX package's params.

Mixed precision as in JAX: parameters fp32; with ``dtype=torch.bfloat16``
the torso (convs, ``emb_layers``, ``qkv``/``proj_out``) runs in bf16 while
``time_embed`` and the head stay fp32; GroupNorm statistics and softmax are
fp32 inside the ops.

Routing (adm_unet.py:105-111, 183-260, 304-309), eval mode only. A map is
"tiled" when it is NHWC with H W C * 4 >= ``set_tiled_gn_min_bytes`` (2 MiB)
and H even. A residual block whose input and output maps are tiled, with no
resample, scale-shift norm and no conv skip, runs its two stages as
``gn_silu_conv_block`` (GroupNorm stats kernel -> halo conv kernel); the
up/down blocks run ``group_norm_film_silu`` (stats -> apply kernels) on
their tiled maps. JAX's two TPU-only conditions of the halo route,
``lanes_ok`` (128 lanes) and ``weights_fit`` (16 MB of VMEM), are dropped.
The routes do not depend on the device: on CPU tensors the wrappers run
their plain versions. Attention takes the flash kernel for ``use_flash``,
T = H W >= 1024 and a CUDA tensor (JAX: a TPU backend), else the dense
``qkv_attention``.

Ported: ``ADMUNet`` with its blocks, class conditioning, both resample
forms and both attention orders. ``EncoderUNetADM``, ``SuperResADM`` and
``AttentionPool2d`` wait (ROADMAP).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffpure_tpu_torch.models.layers import _cast, _Derived, \
    adm_timestep_embedding
from diffpure_tpu_torch.ops.attention import qkv_attention
from diffpure_tpu_torch.ops.conv import conv2d_nhwc
from diffpure_tpu_torch.ops.flash_attention import qkv_flash_attention
from diffpure_tpu_torch.ops.groupnorm import group_norm
from diffpure_tpu_torch.ops.halo_conv import gn_silu_conv_block, \
    pack_halo_weights
from diffpure_tpu_torch.ops.tiled_groupnorm import group_norm_film_silu
from diffpure_tpu_torch.ops.upfirdn2d import naive_downsample_2d, \
    naive_upsample_2d

Tensor = torch.Tensor

GN_GROUPS, GN_EPS = 32, 1e-5

# maps at least this large (fp32 bytes per example) take the tiled routes
_DEFAULT_TILED_GN_MIN_BYTES = 2 * 1024 * 1024
_TILED_GN_MIN_BYTES = _DEFAULT_TILED_GN_MIN_BYTES


def set_tiled_gn_min_bytes(n: Optional[int]) -> None:
    """Override the tiled-GN / halo threshold (None restores 2 MiB), so that
    tests reach those routes at small sizes (adm_unet.py:96-102)."""
    global _TILED_GN_MIN_BYTES
    _TILED_GN_MIN_BYTES = _DEFAULT_TILED_GN_MIN_BYTES if n is None else int(n)


def use_tiled_gn(shape) -> bool:
    """The tiled routes' gate for an NHWC map of this shape."""
    if len(shape) != 4:
        return False
    H, W, C = shape[1], shape[2], shape[3]
    return H * W * C * 4 >= _TILED_GN_MIN_BYTES and H % 2 == 0


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


def _conv(conv: nn.Conv2d, x: Tensor, stride: int = 1) -> Tensor:
    """The conv in x's dtype (nn.Conv with the torso's dtype)."""
    return conv2d_nhwc(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=stride)


def _hwio(conv: nn.Conv2d) -> Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _pack_halo(tensors, dtype, device):
    w, w_proj = tensors
    return pack_halo_weights(w.permute(2, 3, 1, 0),
                             None if w_proj is None else w_proj[:, :, 0, 0].t(),
                             dtype, device)


class ResBlockADM(nn.Module):
    """ADM residual block with FiLM conditioning (ref unet.py:151-265)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 use_conv_skip: bool = False, use_scale_shift_norm: bool = True,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.out_channels = out_channels
        self.use_scale_shift_norm = use_scale_shift_norm
        self.use_conv_skip = use_conv_skip
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(_gn(channels), nn.SiLU(),
                                       nn.Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(
            emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels))
        self.out_layers = nn.Sequential(_gn(out_channels), nn.SiLU(), nn.Dropout(0.0),
                                        nn.Conv2d(out_channels, out_channels, 3, padding=1))
        if out_channels == channels:
            self.skip_connection = nn.Identity()
        elif use_conv_skip:
            self.skip_connection = nn.Conv2d(channels, out_channels, 3, padding=1)
        else:
            self.skip_connection = nn.Conv2d(channels, out_channels, 1)
        self._emb = _Derived(_cast)
        self._halo_in = _Derived(_pack_halo)
        self._halo_out = _Derived(_pack_halo)

    def _emb_out(self, emb: Tensor, dtype: torch.dtype) -> Tensor:
        lin = self.emb_layers[1]
        wb = (lin.weight, lin.bias)
        if torch.is_grad_enabled() and lin.weight.requires_grad:
            w, b = _cast(wb, dtype, emb.device)
        else:
            w, b = self._emb.get(wb, dtype, emb.device)
        return F.linear(F.silu(emb).to(dtype), w, b)

    def forward(self, x: Tensor, emb: Tensor) -> Tensor:
        """x (N, H, W, C) in the torso's dtype; emb (N, emb_channels) fp32."""
        in_ch = x.shape[-1]
        gn_in, conv_in = self.in_layers[0], self.in_layers[2]
        gn_out, conv_out = self.out_layers[0], self.out_layers[3]
        emb_out = self._emb_out(emb, x.dtype)
        tiled = use_tiled_gn(x.shape)

        if (tiled and not (self.up or self.down) and self.use_scale_shift_norm
                and not self.use_conv_skip
                and use_tiled_gn(x.shape[:3] + (self.out_channels,))):
            # two streamed stages: [GN+SiLU+conv] and [GN+FiLM+SiLU+conv+skip]
            scale, shift = emb_out.chunk(2, dim=-1)
            proj = None if in_ch == self.out_channels else self.skip_connection
            on_card = x.device.type == "cuda"
            if proj is not None:
                w_proj = proj.weight[:, :, 0, 0].t()
                b_out = conv_out.bias + proj.bias  # the projection's bias folded in
            else:
                w_proj, b_out = None, conv_out.bias
            h = gn_silu_conv_block(
                x, gn_in.weight, gn_in.bias, None, None, _hwio(conv_in), conv_in.bias,
                None, None, None, GN_GROUPS, GN_EPS,
                packed=self._halo_in.get((conv_in.weight, None), x.dtype, x.device)
                if on_card else None)
            return gn_silu_conv_block(
                h, gn_out.weight, gn_out.bias, scale, shift, _hwio(conv_out), b_out,
                x, w_proj, None, GN_GROUPS, GN_EPS,
                packed=self._halo_out.get(
                    (conv_out.weight, None if proj is None else proj.weight),
                    x.dtype, x.device) if on_card else None)

        if tiled:
            h = group_norm_film_silu(x, gn_in.weight, gn_in.bias, GN_GROUPS, GN_EPS,
                                     None, None, True)
        else:
            h = F.silu(group_norm(x, gn_in.weight, gn_in.bias, GN_GROUPS, GN_EPS))
        if self.up:
            h, x = naive_upsample_2d(h), naive_upsample_2d(x)
        elif self.down:
            h, x = naive_downsample_2d(h), naive_downsample_2d(x)
        h = _conv(conv_in, h)

        tiled_h = use_tiled_gn(h.shape)
        if self.use_scale_shift_norm:
            scale, shift = emb_out.to(h.dtype).chunk(2, dim=-1)
            if tiled_h:
                h = group_norm_film_silu(h, gn_out.weight, gn_out.bias, GN_GROUPS,
                                         GN_EPS, scale, shift, True)
            else:
                h = group_norm(h, gn_out.weight, gn_out.bias, GN_GROUPS, GN_EPS) \
                    * (1 + scale[:, None, None, :]) + shift[:, None, None, :]
                h = F.silu(h)
        else:
            h = h + emb_out[:, None, None, :].to(h.dtype)
            if tiled_h:
                h = group_norm_film_silu(h, gn_out.weight, gn_out.bias, GN_GROUPS,
                                         GN_EPS, None, None, True)
            else:
                h = F.silu(group_norm(h, gn_out.weight, gn_out.bias, GN_GROUPS, GN_EPS))
        h = _conv(conv_out, h)
        skip = x if isinstance(self.skip_connection, nn.Identity) \
            else _conv(self.skip_connection, x)
        return skip + h


def attention_route(use_flash: bool, T: int, device_type: str) -> str:
    """'flash' for ``use_flash`` blocks of T >= 1024 tokens on a CUDA tensor
    (JAX's gate, diffpure_tpu/models/adm_unet.py:304); else 'dense',
    ``qkv_attention``. On the flash route a (T, D) the kernel does not take
    raises (``check_flash_shape``): the dense path is never a stand-in for
    the kernel on the card."""
    return "flash" if use_flash and T >= 1024 and device_type == "cuda" else "dense"


class AttentionBlockADM(nn.Module):
    """Spatial self-attention (ref unet.py:267-333): qkv and proj_out are
    conv1d weights (out, in, 1), applied as products over channels."""

    def __init__(self, channels: int, num_heads: int = 1, num_head_channels: int = -1,
                 use_new_attention_order: bool = False, use_flash: bool = False):
        super().__init__()
        if num_head_channels == -1:
            self.num_heads = num_heads
        else:
            if channels % num_head_channels:
                raise ValueError(f"{channels} channels do not split into heads of "
                                 f"{num_head_channels}")
            self.num_heads = channels // num_head_channels
        self.order = "new" if use_new_attention_order else "legacy"
        self.use_flash = use_flash
        self.norm = _gn(channels)
        self.qkv = nn.Conv1d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv1d(channels, channels, 1)

    def forward(self, x: Tensor) -> Tensor:
        N, H, W, C = x.shape
        h = x.reshape(N, H * W, C)
        hn = group_norm(h[:, :, None, :], self.norm.weight, self.norm.bias, GN_GROUPS,
                        GN_EPS)[:, :, 0, :]
        dt = x.dtype
        qkv = F.linear(hn, self.qkv.weight[:, :, 0].to(dt), self.qkv.bias.to(dt))
        if attention_route(self.use_flash, H * W, x.device.type) == "flash":
            a = qkv_flash_attention(qkv, self.num_heads, order=self.order)
        else:
            a = qkv_attention(qkv, self.num_heads, order=self.order)
        a = F.linear(a, self.proj_out.weight[:, :, 0].to(dt), self.proj_out.bias.to(dt))
        return (h + a).reshape(N, H, W, C)


class UpsampleADM(nn.Module):
    """Nearest 2x upsample + optional conv (ref unet.py:89-118)."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool = True):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        x = naive_upsample_2d(x)
        return _conv(self.conv, x) if self.use_conv else x


class DownsampleADM(nn.Module):
    """Stride-2 conv (padding 1) or 2x2 mean-pool downsample
    (ref unet.py:121-144)."""

    def __init__(self, channels: int, out_channels: int, use_conv: bool = True):
        super().__init__()
        self.use_conv = use_conv
        if use_conv:
            self.op = nn.Conv2d(channels, out_channels, 3, stride=2, padding=1)

    def forward(self, x: Tensor) -> Tensor:
        return _conv(self.op, x, stride=2) if self.use_conv else naive_downsample_2d(x)


class ADMUNet(nn.Module):
    """Full ADM UNet (ref unet.py:404-671). forward(x NHWC, integer
    timesteps (N,), y labels or None) -> (N, H, W, out_channels) in x's
    dtype."""

    def __init__(self, image_size: int = 256, in_channels: int = 3,
                 model_channels: int = 256, out_channels: int = 6,
                 num_res_blocks: int = 2,
                 attention_resolutions: Tuple[int, ...] = (8, 16, 32),
                 dropout: float = 0.0,
                 channel_mult: Tuple[float, ...] = (1, 1, 2, 2, 4, 4),
                 conv_resample: bool = True, num_classes: Optional[int] = None,
                 num_heads: int = 4, num_head_channels: int = 64,
                 num_heads_upsample: int = -1, use_scale_shift_norm: bool = True,
                 resblock_updown: bool = True, use_new_attention_order: bool = False,
                 use_flash: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        # dropout is training-only: eval mode ignores it, as JAX's
        # deterministic Dropout does
        self.model_channels = model_channels
        self.num_classes = num_classes
        self.dtype = dtype
        heads_up = num_heads if num_heads_upsample == -1 else num_heads_upsample
        temb = model_channels * 4
        self.time_embed = nn.Sequential(nn.Linear(model_channels, temb), nn.SiLU(),
                                        nn.Linear(temb, temb))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, temb)

        def res(cin, cout, **kw):
            return ResBlockADM(cin, temb, cout, use_scale_shift_norm=use_scale_shift_norm, **kw)

        def attn(c, heads):
            return AttentionBlockADM(c, heads, num_head_channels, use_new_attention_order,
                                     use_flash)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([nn.ModuleList([
            nn.Conv2d(in_channels, ch, 3, padding=1)])])
        chans = [ch]
        ds = 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, int(mult * model_channels))]
                ch = int(mult * model_channels)
                if ds in attention_resolutions:
                    layers.append(attn(ch, num_heads))
                self.input_blocks.append(nn.ModuleList(layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(nn.ModuleList([
                    res(ch, ch, down=True) if resblock_updown
                    else DownsampleADM(ch, ch, conv_resample)]))
                chans.append(ch)
                ds *= 2
        self.middle_block = nn.ModuleList([res(ch, ch), attn(ch, num_heads), res(ch, ch)])
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + chans.pop(), int(model_channels * mult))]
                ch = int(model_channels * mult)
                if ds in attention_resolutions:
                    layers.append(attn(ch, heads_up))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True) if resblock_updown
                                  else UpsampleADM(ch, ch, conv_resample))
                    ds //= 2
                self.output_blocks.append(nn.ModuleList(layers))
        assert not chans
        self.out = nn.Sequential(_gn(ch), nn.SiLU(), nn.Conv2d(ch, out_channels, 3, padding=1))

    @staticmethod
    def _run(layers, h: Tensor, emb: Tensor) -> Tensor:
        for layer in layers:
            h = layer(h, emb) if isinstance(layer, ResBlockADM) else layer(h)
        return h

    def forward(self, x: Tensor, timesteps: Tensor, y: Optional[Tensor] = None) -> Tensor:
        if (y is not None) != (self.num_classes is not None):
            raise ValueError("class labels go with a class-conditional model only")
        emb = adm_timestep_embedding(timesteps, self.model_channels)
        emb = self.time_embed[2](F.silu(self.time_embed[0](emb)))
        if y is not None:
            emb = emb + self.label_emb(y)

        input_dtype = x.dtype
        h = x.to(self.dtype or x.dtype)
        hs = [_conv(self.input_blocks[0][0], h)]
        for layers in self.input_blocks[1:]:
            hs.append(self._run(layers, hs[-1], emb))
        h = self._run(self.middle_block, hs[-1], emb)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=-1), emb)
        assert not hs

        h = h.to(input_dtype)
        gn, head = self.out[0], self.out[2]
        h = F.silu(group_norm(h, gn.weight, gn.bias, GN_GROUPS, GN_EPS))
        return conv2d_nhwc(h, head.weight, head.bias)


def imagenet256_config(use_bf16: bool = True) -> dict:
    """ADM hyperparameters of the 256x256_diffusion_uncond checkpoint
    (adm_unet.py:610; ref configs/imagenet.yml + script_util.py:138-192),
    with the flash kernel at the 1024-token blocks."""
    return dict(
        image_size=256, in_channels=3, model_channels=256, out_channels=6,
        num_res_blocks=2, attention_resolutions=(8, 16, 32), dropout=0.0,
        channel_mult=(1, 1, 2, 2, 4, 4), num_heads=4, num_head_channels=64,
        use_scale_shift_norm=True, resblock_updown=True,
        use_new_attention_order=False, use_flash=True,
        dtype=torch.bfloat16 if use_bf16 else None)
