"""Evaluation subsets, the CIFAR-10 half (port of
diffpure_tpu/data/datasets.py:29-70, :201-224).

Fixed ``num_sub`` subsets drawn with
``np.random.RandomState(data_seed).choice(N, num_sub, replace=False)``, the
reference's indices (ref datasets.py:319,333), from the standard python
pickle batches on the filesystem. Outputs are NHWC float32 in [0, 1]
numpy arrays; the caller moves them to its device. ImageNet and CelebA-HQ
wait for ROADMAP items 16 and 17.
"""
from __future__ import annotations

import os
import pickle
from typing import Tuple

import numpy as np


def _to_float01(img_u8: np.ndarray) -> np.ndarray:
    return img_u8.astype(np.float32) / 255.0


def _load_cifar10_test(root: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read the standard cifar-10-batches-py test batch (a pickle of the
    dataset's own files, trusted as the reference trusts it)."""
    path = os.path.join(root, "cifar-10-batches-py", "test_batch")
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y = np.asarray(d[b"labels"], dtype=np.int32)
    return _to_float01(x), y


def cifar10_subset(root: str = "./dataset", num_sub: int = -1,
                   data_seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """ref datasets.py:329-336 (the same RandomState subset indices)."""
    x, y = _load_cifar10_test(root)
    if num_sub > 0:
        idx = np.random.RandomState(data_seed).choice(len(x), num_sub,
                                                      replace=False)
        x, y = x[idx], y[idx]
    return x, y


def load_data(domain: str, num_sub: int, data_seed: int,
              root: str = "./dataset", classifier_name: str = "",
              adv_batch_size: int = 64, shard: int = 0, num_shards: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Domain dispatch (ref utils.py:256-289). Process ``shard`` of
    ``num_shards`` keeps subset[shard::num_shards]: every process draws the
    same indices, so the split needs no coordination."""
    if "imagenet" in domain:
        raise NotImplementedError(
            "the ImageNet data readers wait for ROADMAP Slice 3 item 16")
    if "cifar10" in domain:
        x, y = cifar10_subset(root, num_sub=num_sub, data_seed=data_seed)
        return x[shard::num_shards], y[shard::num_shards]
    if "celebahq" in domain:
        raise NotImplementedError(
            "the CelebA-HQ data reader waits for ROADMAP Slice 4 item 17")
    raise NotImplementedError(f"unknown domain {domain}")
