"""The port's ImageNet readers against diffpure_tpu's: a seeded image-folder
fixture (two classes, JPEG and PNG, colour and grey, odd sizes) and the
same files in an LMDB cache written by tests/lmdb_fixture.write_lmdb; the
same images and labels from both packages, whole and as RandomState
subsets, through load_data (the LMDB first, then the folder)."""
import io
import os

import numpy as np
import pytest
from PIL import Image

from diffpure_tpu.data import datasets as jds
from diffpure_tpu.data.lmdb_reader import LMDBReader as JaxLMDBReader
from diffpure_tpu_torch.data import imagenet_lmdb_val_subset, imagenet_val_subset, \
    imval_transform, load_data
from diffpure_tpu_torch.data.lmdb_reader import LMDBReader
from lmdb_fixture import write_lmdb

# (class, file, size, mode, format)
FILES = [("n01440764", "a.JPEG", (300, 260), "RGB", "JPEG"),
         ("n01440764", "b.png", (256, 320), "RGB", "PNG"),
         ("n01440764", "c.JPEG", (230, 230), "L", "JPEG"),
         ("n01443537", "d.JPEG", (400, 240), "RGB", "JPEG"),
         ("n01443537", "e.png", (224, 500), "RGB", "PNG")]


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    """<root>/imagenet/val/<class>/<file>, and the same bytes keyed by path
    in <root>/lmdb/val_faster_imagefolder.lmdb."""
    root = tmp_path_factory.mktemp("dataset")
    rng = np.random.default_rng(0)
    entries = {}
    for cls, name, (w, h), mode, fmt in FILES:
        d = root / "imagenet" / "val" / cls
        d.mkdir(parents=True, exist_ok=True)
        px = rng.integers(0, 256, (h, w, 3 if mode == "RGB" else 1), dtype=np.uint8)
        buf = io.BytesIO()
        Image.fromarray(px.squeeze(-1) if mode == "L" else px, mode).save(buf, fmt)
        (d / name).write_bytes(buf.getvalue())
        entries[f"val/{cls}/{name}".encode("ascii")] = buf.getvalue()
    write_lmdb(str(root / "lmdb" / "val_faster_imagefolder.lmdb"), entries)
    return root


def _equal(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].dtype == np.float32 and got[0].shape[1:] == (224, 224, 3)
    assert got[1].dtype == np.int32


@pytest.mark.parametrize("num_sub, seed", [(-1, 0), (3, 0), (3, 5)])
def test_folder_and_lmdb_subsets_match_jax(imagenet_root, num_sub, seed):
    val = str(imagenet_root / "imagenet" / "val")
    lmdb = str(imagenet_root / "lmdb" / "val_faster_imagefolder.lmdb")
    folder = imagenet_val_subset(val, num_sub, seed)
    _equal(folder, jds.imagenet_val_subset(val, num_sub, seed))
    cached = imagenet_lmdb_val_subset(lmdb, num_sub, seed)
    _equal(cached, jds.imagenet_lmdb_val_subset(lmdb, num_sub, seed))
    _equal(cached, folder)  # the cache holds the folder's images in its order
    if num_sub < 0:
        assert folder[1].tolist() == [0, 0, 0, 1, 1]


def test_load_data_takes_the_lmdb_first(imagenet_root, tmp_path):
    root = str(imagenet_root)
    for shard in range(2):
        _equal(load_data("imagenet", 4, 1, root=root, shard=shard, num_shards=2),
               jds.load_data("imagenet", 4, 1, root=root, shard=shard, num_shards=2))
    # an LMDB beside val/ wins over the folder: here one with other labels
    other = tmp_path / "imagenet"
    other.mkdir()
    os.symlink(imagenet_root / "imagenet" / "val", other / "val")
    with LMDBReader(str(imagenet_root / "lmdb" / "val_faster_imagefolder.lmdb")) as r:
        items = {k.replace(b"n01440764", b"n09999999"): v for k, v in r.items()}
    write_lmdb(str(other / "val_faster_imagefolder.lmdb"), items)
    got = load_data("imagenet", -1, 0, root=str(tmp_path))
    _equal(got, jds.load_data("imagenet", -1, 0, root=str(tmp_path)))
    assert got[1].tolist() == [0, 0, 1, 1, 1]  # the folder's would be [0, 0, 0, 1, 1]


def test_lmdb_reader_matches_jax(imagenet_root):
    path = str(imagenet_root / "lmdb" / "val_faster_imagefolder.lmdb")
    with LMDBReader(path) as r, JaxLMDBReader(path) as j:
        assert list(r.items()) == list(j.items())
        assert len(r) == len(j) == len(FILES) and r.stat() == j.stat()
        key = b"val/n01443537/d.JPEG"
        assert r[key] == j[key] and key in r and b"val/x" not in r


def test_imval_transform_matches_jax():
    rng = np.random.default_rng(1)
    for w, h in ((500, 375), (224, 224), (257, 300)):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        got = imval_transform(img)
        np.testing.assert_array_equal(got, jds.imval_transform(img))
        assert got.shape == (224, 224, 3) and 0.0 <= got.min() <= got.max() <= 1.0
