"""Model construction from the YAML configs (port of
diffpure_tpu/models/factories.py:259 ncsnpp_from_config)."""
from __future__ import annotations

from diffpure_tpu_torch.models.ncsnpp import NCSNpp


def ncsnpp_from_config(config, dtype=None) -> NCSNpp:
    """NCSNpp from a reference-style config namespace (``config.model`` /
    ``config.data``); unknown names fall back to the NCSNpp defaults."""
    m = config.model
    d = config.data
    g = lambda ns, k, default: getattr(ns, k, default)  # noqa: E731
    return NCSNpp(
        image_size=g(d, "image_size", 32),
        num_channels=g(d, "num_channels", 3),
        nf=g(m, "nf", 128),
        ch_mult=tuple(g(m, "ch_mult", (1, 2, 2, 2))),
        num_res_blocks=g(m, "num_res_blocks", 8),
        attn_resolutions=tuple(g(m, "attn_resolutions", (16,))),
        dropout=g(m, "dropout", 0.1),
        resamp_with_conv=g(m, "resamp_with_conv", True),
        conditional=g(m, "conditional", True),
        fir=g(m, "fir", False),
        fir_kernel=tuple(g(m, "fir_kernel", (1, 3, 3, 1))),
        skip_rescale=g(m, "skip_rescale", True),
        resblock_type=g(m, "resblock_type", "biggan"),
        progressive=g(m, "progressive", "none"),
        progressive_input=g(m, "progressive_input", "none"),
        progressive_combine=g(m, "progressive_combine", "sum"),
        embedding_type=g(m, "embedding_type", "positional"),
        fourier_scale=float(g(m, "fourier_scale", 16.0)),
        init_scale=g(m, "init_scale", 0.0),
        scale_by_sigma=g(m, "scale_by_sigma", False),
        centered=g(d, "centered", True),
        sigma_min=g(m, "sigma_min", 0.01),
        sigma_max=g(m, "sigma_max", 50.0),
        num_scales=g(m, "num_scales", 1000),
        dtype=dtype,
    )
