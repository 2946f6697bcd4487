"""The port's debugging and profiling utilities and the purification's
debug dumps, against diffpure_tpu's where both compute something:
``nan_guard`` in the forward and the backward, ``checkified`` with the
checks, ``make_grid`` exactly JAX's, ``save_image`` /
``dump_purification_debug`` read back, ``DefendedModel(debug_dir=...)``,
``flops_estimate`` of a matmul (2 m n k, as tests/test_utils_aux.py holds
JAX's), ``trace`` / ``annotate``; and every module of the port importing
first in a fresh interpreter state (no import cycle)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from diffpure_tpu.utils.images import make_grid as jmake_grid
from diffpure_tpu_torch.eval import DefendedModel
from diffpure_tpu_torch.purify import PurifyConfig
from diffpure_tpu_torch.utils import debug, images, profiling


class TestNanGuard:
    def test_forward_nan_raises_at_its_operator(self):
        x = torch.tensor([1.0, 2.0])
        with pytest.raises(FloatingPointError, match="aten.log"):
            with debug.nan_guard():
                torch.log(x - 1.5)
        torch.log(x - 1.5)  # outside the guard nothing checks
        with debug.nan_guard(False):
            torch.log(x - 1.5)

    def test_backward_nan_raises(self):
        x = torch.tensor([1.0, 2.0], requires_grad=True)
        with debug.nan_guard():
            y = torch.sqrt(x - 1.0)  # sqrt(0) = 0: finite forward
            with pytest.raises(FloatingPointError):
                (y * 0.0).sum().backward()  # 0 * d sqrt / dx at 0 = 0 * inf

    def test_infinities_pass_as_in_jax(self):
        with debug.nan_guard():
            assert torch.isinf(torch.log(torch.zeros(2))).all()


class TestCheckified:
    def test_user_and_nan_checks_become_errors(self):
        f = debug.checkified(lambda v: debug.assert_finite(torch.log(v), "logv"))
        err, out = f(torch.tensor([1.0, 2.0]))
        assert err.get() is None and out.shape == (2,)
        err.throw()
        err, _ = f(torch.tensor([-1.0]))  # log(-1): the nan check fires first
        assert "nan" in err.get()
        with pytest.raises(debug.CheckError):
            err.throw()
        user_only = debug.checkified(lambda v: debug.assert_finite(torch.log(v), "logv"),
                                     errors=("user",))
        assert user_only(torch.tensor([0.0]))[0].get() == "logv contains non-finite values"
        rng = debug.checkified(lambda v: debug.assert_in_range(v, 0.0, 1.0, "t"))
        assert rng(torch.tensor([0.5]))[0].get() is None
        assert rng(torch.tensor([1.5]))[0].get() == "t out of range [0.0, 1.0]"

    def test_checks_are_noops_outside(self):
        bad = torch.tensor([float("nan")])
        assert debug.assert_finite(bad) is bad
        assert debug.assert_in_range(bad + 5, 0.0, 1.0) is not None
        with pytest.raises(debug.CheckError):
            with debug.nan_guard():
                debug.assert_in_range(torch.tensor([2.0]), 0.0, 1.0)


class TestImages:
    @pytest.mark.parametrize("n,nrow", [(5, 8), (8, 3), (1, 1)])
    def test_make_grid_is_jax(self, n, nrow):
        x = np.random.default_rng(n).uniform(size=(n, 4, 6, 3)).astype(np.float32)
        got = images.make_grid(torch.from_numpy(x), nrow=nrow)
        assert np.array_equal(got, jmake_grid(x, nrow=nrow))

    def test_dump_read_back(self, tmp_path):
        from PIL import Image

        x = np.random.default_rng(0).uniform(-1, 1, size=(3, 4, 4, 3)).astype(np.float32)
        images.dump_purification_debug(str(tmp_path), 0, "t", x_input=torch.from_numpy(x),
                                       x_purified=torch.from_numpy(x))
        out = tmp_path / "bs0_t"
        assert sorted(os.listdir(out)) == ["original_input.png", "samples_0.npy",
                                           "samples_0.png"]
        assert np.array_equal(np.load(out / "samples_0.npy"), x)
        png = np.asarray(Image.open(out / "samples_0.png")).astype(np.float32) / 255
        grid = images.make_grid((x + 1) / 2)
        assert png.shape == grid.shape and np.abs(png - grid).max() <= 0.5 / 255 + 1e-6
        images.dump_purification_debug(str(tmp_path), 2, "t", x_input=x)  # past the limit
        assert not (tmp_path / "bs2_t").exists()


def _tiny_defence(debug_dir=None):
    from diffpure_tpu_torch.models import NCSNpp
    from diffpure_tpu_torch.utils.weights import seeded_normal_state_dict

    score = NCSNpp(image_size=8, nf=16, ch_mult=(1,), num_res_blocks=1,
                   attn_resolutions=()).eval()
    score.load_state_dict({k: torch.from_numpy(v) for k, v in
                           seeded_normal_state_dict(score, 0).items()})
    return DefendedModel(score, lambda x: x.mean(dim=(1, 2)), PurifyConfig(t=1, grad_mode="none"),
                         log_every=0, tag="dm", debug_dir=debug_dir)


def test_defended_debug_dir_dumps_the_first_two_calls(tmp_path, monkeypatch):
    dm = _tiny_defence(str(tmp_path))
    x = torch.from_numpy(np.random.default_rng(1).uniform(size=(10, 8, 8, 3)).astype(np.float32))
    with torch.no_grad():
        outs = [dm.purify(x, s) for s in range(3)]
    assert sorted(os.listdir(tmp_path)) == ["bs0_dm", "bs1_dm"]
    for i in range(2):
        saved = np.load(tmp_path / f"bs{i}_dm" / "samples_0.npy")
        assert saved.shape == (8, 8, 8, 3)  # x[:8]
        assert np.allclose(saved, (outs[i][:8] * 2 - 1).numpy(), atol=1e-6)
    # without debug_dir nothing is copied to the host
    monkeypatch.setattr("diffpure_tpu_torch.eval.defended.dump_purification_debug",
                        lambda *a, **k: pytest.fail("dumped without debug_dir"))
    with torch.no_grad():
        _tiny_defence().purify(x, 0)


class TestProfiling:
    def test_flops_estimate_of_a_matmul(self):
        f = profiling.flops_estimate(lambda a, b: a @ b, torch.ones(64, 128),
                                     torch.ones(128, 256))
        assert f == 2 * 64 * 128 * 256

    def test_flops_estimate_none_where_it_fails(self):
        def broken(a):
            raise RuntimeError("no")
        assert profiling.flops_estimate(broken, torch.ones(1)) is None

    def test_attention_flops_formula(self):
        assert profiling.attention_flops(2, 4096, 512) == 2 * 2 * 4096 ** 2 * 512

    def test_trace_and_annotate(self, tmp_path):
        with profiling.trace(str(tmp_path)):
            with profiling.annotate("my_range"):
                torch.ones(8, 8) @ torch.ones(8, 8)
        events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
        assert any(e.get("name") == "my_range" for e in events)
        with profiling.trace(None):  # no directory: no profiling
            pass


def test_every_module_imports_first():
    """Each module of the port imported first, with every module of the
    package dropped before it, in one fresh interpreter: an import cycle
    (the samplers' time grid once came from solvers.dpm, which imports the
    diffusion package back) fails here."""
    code = """
import importlib, pkgutil, sys
import diffpure_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'diffpure_tpu_torch.')]
bad = []
for name in names:
    for k in [k for k in sys.modules if k.startswith('diffpure_tpu_torch')]:
        del sys.modules[k]
    try:
        importlib.import_module(name)
    except Exception as e:
        bad.append(f'{name}: {e!r}')
print(len(names)); print('\\n'.join(bad))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=root, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert int(lines[0]) > 80 and lines[1:] == [], lines[1:]
