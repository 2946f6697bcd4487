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
print(sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'flax', 'diffpure_tpu')))
"""


def test_import_leaves_jax_out():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_no_jax_import_statement():
    pattern = re.compile(r"^\s*(import|from) (jax|flax|diffpure_tpu)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert offenders == []
