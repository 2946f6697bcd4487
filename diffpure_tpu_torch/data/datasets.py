"""Evaluation subsets, CIFAR-10, ImageNet and CelebA-HQ (port of
diffpure_tpu/data/datasets.py:29-233).

Fixed ``num_sub`` subsets drawn with
``np.random.RandomState(data_seed).choice(N, num_sub, replace=False)``, the
reference's indices (ref datasets.py:319,333), from the filesystem:
CIFAR-10's python pickle batches; ImageNet's class-per-directory val
folder or the reference's LMDB cache beside it (read by the pure-Python
``data/lmdb_reader.py``), decoded by Pillow (imported when an image is
read, as in JAX); CelebA-HQ's images folder with the CelebA attribute and
partition lists beside it. Outputs are NHWC float32 in [0, 1] numpy
arrays; the caller moves them to its device.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Tuple

import numpy as np


def _to_float01(img_u8: np.ndarray) -> np.ndarray:
    return img_u8.astype(np.float32) / 255.0


def imval_transform(img, base_size: int = 224) -> np.ndarray:
    """Resize(256) + CenterCrop(base_size) as torchvision's 'imval'
    (ref datasets.py:189-254; JAX :33). img: a PIL image. HWC float [0, 1]."""
    from PIL import Image
    w, h = img.size
    scale = 256 / min(w, h)
    img = img.resize((max(int(round(w * scale)), 256),
                      max(int(round(h * scale)), 256)), Image.BILINEAR)
    w, h = img.size
    left = (w - base_size) // 2
    top = (h - base_size) // 2
    img = img.crop((left, top, left + base_size, top + base_size))
    return _to_float01(np.asarray(img.convert("RGB")))


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


def _subset(samples: list, num_sub: int, data_seed: int) -> list:
    if num_sub > 0:
        idx = np.random.RandomState(data_seed).choice(len(samples), num_sub,
                                                      replace=False)
        samples = [samples[i] for i in idx]
    return samples


def imagenet_val_subset(root: str, num_sub: int = -1, data_seed: int = 0,
                        base_size: int = 224) -> Tuple[np.ndarray, np.ndarray]:
    """Class-per-directory val folder -> (x, y), the reference's subset
    protocol (ref datasets.py:311-326; JAX :77). The class index is the
    position among the sorted directory names, as torchvision's
    ImageFolder has it."""
    from PIL import Image
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    samples = [(os.path.join(root, c, f), ci) for ci, c in enumerate(classes)
               for f in sorted(os.listdir(os.path.join(root, c)))]
    xs, ys = [], []
    for path, ci in _subset(samples, num_sub, data_seed):
        with Image.open(path) as img:
            xs.append(imval_transform(img, base_size))
        ys.append(ci)
    return np.stack(xs), np.asarray(ys, dtype=np.int32)


def imagenet_lmdb_val_subset(lmdb_path: str, num_sub: int = -1,
                             data_seed: int = 0, base_size: int = 224
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """The val subset from the reference's LMDB cache (ref datasets.py:
    261-326; JAX :103): keys are the images' file paths (ascii), values
    their bytes. The class index is the parent directory's rank among the
    sorted class names; LMDB's byte-sorted keys give ImageFolder's (sorted
    class, sorted file) order, so the subset indices pick the same images."""
    import io

    from PIL import Image

    from diffpure_tpu_torch.data.lmdb_reader import LMDBReader

    def class_of(k: bytes) -> str:
        return os.path.basename(os.path.dirname(k.decode("ascii")))

    with LMDBReader(lmdb_path) as r:
        keys = list(r.keys())
        cidx = {c: i for i, c in enumerate(sorted({class_of(k) for k in keys}))}
        xs, ys = [], []
        for k, ci in _subset([(k, cidx[class_of(k)]) for k in keys], num_sub, data_seed):
            with Image.open(io.BytesIO(r[k])) as img:
                xs.append(imval_transform(img.convert("RGB"), base_size))
            ys.append(ci)
    return np.stack(xs), np.asarray(ys, dtype=np.int32)


def _celebahq_table(root: str):
    """The image files, attribute names, 0/1 attributes and partitions
    (ref datasets.py:110-129 make_table, without pandas; JAX :141)."""
    filenames = sorted(os.listdir(os.path.join(root, "images")))
    celebahq = [f.replace("png", "jpg") if f.endswith("png") else f for f in filenames]
    with open(os.path.join(root, "list_attr_celeba.txt")) as f:
        lines = f.read().splitlines()
    attr_names = lines[1].split()
    attr_rows = {}
    for line in lines[2:]:
        parts = line.split()
        attr_rows[parts[0]] = np.array([int(v) for v in parts[1:]])
    partitions = {}
    with open(os.path.join(root, "list_eval_partition.txt")) as f:
        for line in f:
            fname, part = line.strip().split(" ")
            partitions[fname] = int(part)
    attrs = np.stack([np.maximum(attr_rows[f], 0) for f in celebahq])
    parts = np.array([partitions[f] for f in celebahq])
    return filenames, attr_names, attrs, parts


def celebahq_subset(root: str, attribute: str, partition: str = "val",
                    fraction: Optional[float] = 2.0, data_seed: int = 1,
                    base_size: int = 256, min_count: int = 1
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """A ``fraction`` percent subset of a partition with its 0/1 labels for
    ``attribute`` (ref datasets.py:133-186; JAX :169). ``min_count`` floors
    the subset, as JAX does: on the real 30k-image CelebA-HQ the 2% slice
    is about 600 images and the floor never binds, on a fixture int(2% of
    8) is 0; the size is clamped to [min_count, len(partition)]."""
    from PIL import Image
    filenames, attr_names, attrs, parts = _celebahq_table(root)
    partition_idx = np.where(parts == dict(train=0, val=1, test=2)[partition])[0]
    if fraction is not None:
        new_length = int(fraction / 100 * len(partition_idx))
        new_length = min(len(partition_idx), max(min_count, new_length))
        rng = np.random.RandomState(data_seed)
        partition_idx = rng.choice(partition_idx, new_length, replace=False)
    ai = attr_names.index(attribute)
    xs, ys = [], []
    for i in partition_idx:
        with Image.open(os.path.join(root, "images", filenames[i])) as img:
            img = img.convert("RGB").resize((base_size, base_size), Image.BILINEAR)
            xs.append(_to_float01(np.asarray(img)))
        ys.append(int(attrs[i, ai]))
    return np.stack(xs), np.asarray(ys, dtype=np.int32)


def load_data(domain: str, num_sub: int, data_seed: int,
              root: str = "./dataset", classifier_name: str = "",
              adv_batch_size: int = 64, shard: int = 0, num_shards: int = 1
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Domain dispatch (ref utils.py:256-289). Process ``shard`` of
    ``num_shards`` keeps subset[shard::num_shards]: every process draws the
    same indices, so the split needs no coordination. ImageNet reads the
    LMDB cache ``<root>/imagenet/val_faster_imagefolder.lmdb`` where it
    exists, else the folder ``<root>/imagenet/val`` (JAX :210-219)."""
    if "imagenet" in domain:
        val_dir = os.path.join(root, "imagenet", "val")
        lmdb_dir = val_dir.rstrip("/") + "_faster_imagefolder.lmdb"
        if os.path.isdir(lmdb_dir):
            x, y = imagenet_lmdb_val_subset(lmdb_dir, num_sub=num_sub,
                                            data_seed=data_seed)
        else:
            x, y = imagenet_val_subset(val_dir, num_sub=num_sub, data_seed=data_seed)
        return x[shard::num_shards], y[shard::num_shards]
    if "cifar10" in domain:
        x, y = cifar10_subset(root, num_sub=num_sub, data_seed=data_seed)
        return x[shard::num_shards], y[shard::num_shards]
    if "celebahq" in domain:
        # the val partition's 2% subset, floored at one batch (JAX :225-230)
        attribute = classifier_name.split("__")[-1]
        x, y = celebahq_subset(os.path.join(root, "celebahq"), attribute, partition="val",
                               fraction=2.0, data_seed=data_seed, min_count=adv_batch_size)
        x, y = x[:adv_batch_size], y[:adv_batch_size]
        return x[shard::num_shards], y[shard::num_shards]
    raise NotImplementedError(f"unknown domain {domain}")
