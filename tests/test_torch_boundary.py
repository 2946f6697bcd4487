"""The PyTorch port stands alone: it never imports JAX or the JAX package."""
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "diffpure_tpu_torch"

# Imports every module of the port with jax, flax and diffpure_tpu made
# unimportable, then reports whether any JAX module got loaded.
_PROBE = r"""
import importlib, pkgutil, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'diffpure_tpu'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import diffpure_tpu_torch
for m in pkgutil.walk_packages(diffpure_tpu_torch.__path__, 'diffpure_tpu_torch.'):
    importlib.import_module(m.name)
print(sorted(k for k in sys.modules if k.startswith('diffpure_tpu_torch.')))
print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'diffpure_tpu')))
"""
# modules of the gradient slice, which the walk must reach
GRADIENT_PATH = ["diffpure_tpu_torch.solvers.adjoint", "diffpure_tpu_torch.attacks.apgd",
                 "diffpure_tpu_torch.attacks.autoattack", "diffpure_tpu_torch.attacks.eot",
                 "diffpure_tpu_torch.attacks.losses", "diffpure_tpu_torch.eval.drivers"]
# modules of the ImageNet-256 slice
IMAGENET_PATH = ["diffpure_tpu_torch.models.adm_unet", "diffpure_tpu_torch.ops.tiled_groupnorm",
                 "diffpure_tpu_torch.ops.halo_conv", "diffpure_tpu_torch.ops.flash_attention",
                 "diffpure_tpu_torch.classifiers.resnet", "diffpure_tpu_torch.models.factories"]


def _probe():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_import_leaves_jax_out():
    assert _probe()[-1] == "[]"


def test_gradient_path_modules_import_without_jax():
    imported = _probe()[-2]
    missing = [m for m in GRADIENT_PATH if repr(m) not in imported]
    assert missing == []


def test_imagenet_path_modules_import_without_jax():
    imported = _probe()[-2]
    missing = [m for m in IMAGENET_PATH if repr(m) not in imported]
    assert missing == []


def test_no_jax_import_statement():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|diffpure_tpu)\b", re.M)
    files = [*PKG.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
    assert offenders == []
