"""Image grids and the purification's debug dumps (port of
diffpure_tpu/utils/images.py; ref runners/diffpure_sde.py:210-243, which
saves torchvision grids of the first two batches). Numpy and Pillow only:
tensors are copied to the host by the caller or here, never on a path
that does not dump.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np


def _host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def make_grid(images01, nrow: int = 8, padding: int = 2) -> np.ndarray:
    """(N, H, W, C) in [0, 1] -> one (GH, GW, C) float32 grid, torchvision's
    layout: ``nrow`` images a row, ``padding`` zero pixels around each."""
    images01 = _host(images01)
    N, H, W, C = images01.shape
    ncol = min(nrow, N)
    nrows = math.ceil(N / ncol)
    grid = np.zeros((nrows * (H + padding) + padding, ncol * (W + padding) + padding, C),
                    dtype=np.float32)
    for i in range(N):
        r, c = divmod(i, ncol)
        y = r * (H + padding) + padding
        x = c * (W + padding) + padding
        grid[y:y + H, x:x + W] = images01[i]
    return grid


def save_image(images01, path: str, nrow: int = 8) -> None:
    """Save a [0, 1] NHWC batch as one PNG grid."""
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = (np.clip(make_grid(images01, nrow=nrow), 0.0, 1.0) * 255).round().astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def dump_purification_debug(log_dir: Optional[str], bs_id: int, tag: str, x_input=None,
                            x_init=None, x_purified=None, max_batches: int = 2) -> None:
    """The first ``max_batches`` batches' dumps in ``log_dir/bs{bs_id}_{tag}/``
    (ref diffpure_sde.py:210-243): original_input.png, init_0.png,
    samples_0.png and samples_0.npy (the purified batch as it came), from
    images in [-1, 1]."""
    if log_dir is None or bs_id >= max_batches:
        return
    out_dir = os.path.join(log_dir, f"bs{bs_id}_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    to01 = lambda v: (_host(v) + 1.0) * 0.5  # noqa: E731
    if x_input is not None:
        save_image(to01(x_input), os.path.join(out_dir, "original_input.png"))
    if x_init is not None:
        save_image(to01(x_init), os.path.join(out_dir, "init_0.png"))
    if x_purified is not None:
        save_image(to01(x_purified), os.path.join(out_dir, "samples_0.png"))
        np.save(os.path.join(out_dir, "samples_0.npy"), _host(x_purified))
