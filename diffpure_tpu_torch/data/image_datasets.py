"""Training image pipeline for diffusion models (port of
diffpure_tpu/data/image_datasets.py, which is numpy and PIL already, so the
two give the same batches for the same seed).

guided_diffusion/image_datasets.py:1-175: recursive
image listing, class labels from filename prefixes, random-crop/flip
training transform and center-crop eval transform, infinite shard-aware
batch iterator (process i of n takes every n-th file — the data-sharding
analog of the reference's MPI rank split). Batches are float32 numpy
arrays; ``TrainLoop.run_loop`` moves them to its model's device.
"""
from __future__ import annotations

import math
import os
import random
from typing import Iterator, List, Optional, Tuple

import numpy as np

IMG_EXTS = {"jpg", "jpeg", "png", "gif", "bmp"}


def list_image_files_recursively(data_dir: str) -> List[str]:
    """ref image_datasets.py:75-85."""
    results = []
    for entry in sorted(os.listdir(data_dir)):
        full_path = os.path.join(data_dir, entry)
        ext = entry.split(".")[-1].lower()
        if "." in entry and ext in IMG_EXTS:
            results.append(full_path)
        elif os.path.isdir(full_path):
            results.extend(list_image_files_recursively(full_path))
    return results


def center_crop_arr(img, image_size: int) -> np.ndarray:
    """ref image_datasets.py:118-135: downsample by halving then resize,
    center crop."""
    from PIL import Image
    while min(*img.size) >= 2 * image_size:
        img = img.resize(tuple(x // 2 for x in img.size), Image.BOX)
    scale = image_size / min(*img.size)
    img = img.resize(tuple(round(x * scale) for x in img.size),
                     Image.BICUBIC)
    arr = np.array(img.convert("RGB"))
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def random_crop_arr(img, image_size: int, min_crop_frac: float = 0.8,
                    max_crop_frac: float = 1.0,
                    rng: Optional[random.Random] = None) -> np.ndarray:
    """ref image_datasets.py:138-160."""
    from PIL import Image
    rng = rng or random
    min_smaller = math.ceil(image_size / max_crop_frac)
    max_smaller = math.ceil(image_size / min_crop_frac)
    smaller_dim_size = rng.randrange(min_smaller, max_smaller + 1)
    while min(*img.size) >= 2 * smaller_dim_size:
        img = img.resize(tuple(x // 2 for x in img.size), Image.BOX)
    scale = smaller_dim_size / min(*img.size)
    img = img.resize(tuple(round(x * scale) for x in img.size),
                     Image.BICUBIC)
    arr = np.array(img.convert("RGB"))
    crop_y = rng.randrange(arr.shape[0] - image_size + 1)
    crop_x = rng.randrange(arr.shape[1] - image_size + 1)
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def load_data(*, data_dir: str, batch_size: int, image_size: int,
              class_cond: bool = False, deterministic: bool = False,
              random_crop: bool = False, random_flip: bool = True,
              shard: int = 0, num_shards: int = 1, seed: int = 0
              ) -> Iterator[Tuple[np.ndarray, dict]]:
    """Infinite iterator of (batch NHWC [-1,1] float32, kwargs dict).

    ref image_datasets.py:12-72: classes parsed from the filename part
    before the first '_'; shard i takes files[i::num_shards].
    """
    from PIL import Image
    if not data_dir:
        raise ValueError("unspecified data directory")
    all_files = list_image_files_recursively(data_dir)
    classes = None
    if class_cond:
        class_names = [os.path.basename(p).split("_")[0] for p in all_files]
        sorted_classes = {n: i for i, n in enumerate(sorted(set(class_names)))}
        classes = [sorted_classes[n] for n in class_names]

    files = all_files[shard::num_shards]
    labels = classes[shard::num_shards] if classes else None
    rng = random.Random(seed)

    def load_one(idx: int) -> Tuple[np.ndarray, dict]:
        with Image.open(files[idx]) as img:
            img.load()
            if random_crop:
                arr = random_crop_arr(img, image_size, rng=rng)
            else:
                arr = center_crop_arr(img, image_size)
        if random_flip and rng.random() < 0.5:
            arr = arr[:, ::-1]
        arr = arr.astype(np.float32) / 127.5 - 1.0
        out = {}
        if labels is not None:
            out["y"] = np.int32(labels[idx])
        return arr, out

    order = list(range(len(files)))
    while True:
        if not deterministic:
            rng.shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            idxs = order[start:start + batch_size]
            arrs, kwargs_list = zip(*(load_one(i) for i in idxs))
            batch = np.stack(arrs)
            kwargs = {}
            if labels is not None:
                kwargs["y"] = np.stack([k["y"] for k in kwargs_list])
            yield batch, kwargs
