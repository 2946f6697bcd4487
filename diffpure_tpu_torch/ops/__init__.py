from diffpure_tpu_torch.ops import flash_attention as _fla
from diffpure_tpu_torch.ops import fused_attnblock as _fab
from diffpure_tpu_torch.ops import fused_resblock as _frb
from diffpure_tpu_torch.ops import groupnorm as _gn
from diffpure_tpu_torch.ops import halo_conv as _halo
from diffpure_tpu_torch.ops import tiled_groupnorm as _tgn
from diffpure_tpu_torch.ops.attention import qkv_attention, spatial_attention
from diffpure_tpu_torch.ops.fused_act import fused_leaky_relu
from diffpure_tpu_torch.ops.groupnorm import group_norm, group_norm_silu, \
    ncsn_num_groups
from diffpure_tpu_torch.ops.upfirdn2d import naive_downsample_2d, \
    naive_upsample_2d

# The wrappers of the hand-written kernels, each with its launch counter.
# (The block wrappers are not re-exported under their own names: they would
# shadow the modules.)
KERNEL_WRAPPERS = (_frb.fused_resblock, _frb.fused_resblock_cat,
                   _fab.fused_attnblock, _frb.fused_resblock_bwd,
                   _frb.fused_resblock_cat_bwd, _tgn.group_stats,
                   _tgn.gn_film_silu_apply, _halo.gn_silu_conv3x3_halo,
                   _fla.flash_attention, _gn.group_norm_silu_fused,
                   fused_leaky_relu)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {f.__name__: f.launches for f in KERNEL_WRAPPERS}


def reset_launch_counts() -> None:
    for f in KERNEL_WRAPPERS:
        f.launches = 0
