"""The plain parts of the bf16 fused-resblock forward on wgmma
(csrc/igemm_wgmma.cuh, csrc/fused_resblock.cu): its weight stages, its
tile and split-K plan over the full-width CIFAR NCSN++'s block census, its
shape gate, and that its wrapper has no route off the CPU but the kernel.
The kernel itself runs only on the card (chip_smoke.py phase 2 holds it
against the plain version at batch 8 and 128); the plain version's parity
with diffpure_tpu is tests/test_torch_fused_resblock.py's."""
from collections import Counter

import numpy as np
import pytest
import torch

from diffpure_tpu_torch.config import load_config
from diffpure_tpu_torch.models import layers, ncsnpp_from_config
from diffpure_tpu_torch.models.adm_unet import attention_route
from diffpure_tpu_torch.ops import _cuda
from diffpure_tpu_torch.ops import fused_resblock as frb
from diffpure_tpu_torch.ops.flash_attention import check_flash_shape
from torch_parity import resblock_params, resblock_params_torch


def stage_index(cin, tap, c, n):
    """Where the stage pack keeps weight (tap, input channel c, output
    channel n): step (c // 64) * 9 + tap, row n, the 16-byte group of c
    swizzled by n % 8 (wgmma's 128-byte swizzle)."""
    return (c // 64) * 9 + tap, n, ((c % 64 // 8) ^ (n % 8)) * 8 + c % 8


@pytest.mark.parametrize("proj", [True, False])
def test_stage_pack_holds_the_oihw_weights(proj):
    """w0s / w1s hold w0[n, c, dy, dx] / w1[n, c, dy, dx] at step (c // 64)
    * 9 + 3 dy + dx, and the projection wskip[n, c] at step 9 cout / 64 +
    c // 64 (centre tap), each row swizzled; the stages are a permutation
    of the weights, in bf16."""
    cin, cout = 128, 128 if not proj else 192
    rng = np.random.default_rng(5)
    p = resblock_params_torch(resblock_params(rng, cin, cout, proj))
    pk = frb.pack_resblock_params(p, torch.bfloat16, "cpu")
    w0, w1, ws = (t.to(torch.bfloat16) for t in (p[2], p[6], p[8] if proj else p[2]))
    steps1 = 9 * cout // 64 + (cin // 64 if proj else 0)
    assert pk.w0s.shape == (9 * cin // 64, cout, 64) and pk.w0s.dtype == torch.bfloat16
    assert pk.w1s.shape == (steps1, cout, 64) and pk.w1s.is_contiguous()
    for n, c, dy, dx in [(0, 0, 0, 0), (5, 70, 1, 2), (127, 127, 2, 2), (64, 9, 2, 0),
                         (100, 63, 0, 1), (33, 64, 1, 1)]:
        tap = 3 * dy + dx
        assert pk.w0s[stage_index(cin, tap, c, n)] == w0[n, c, dy, dx]
        assert pk.w1s[stage_index(cout, tap, c % cout, n)] == w1[n, c % cout, dy, dx]
        if proj:
            s, row, pos = stage_index(cin, 0, c, n)
            assert pk.w1s[9 * cout // 64 + s // 9, row, pos] == ws[n, c]
    assert torch.equal(pk.w0s.float().reshape(-1).sort().values,
                       w0.float().reshape(-1).sort().values)
    flat1 = [w1.float().reshape(-1)] + ([ws.float().reshape(-1)] if proj else [])
    assert torch.equal(pk.w1s.float().reshape(-1).sort().values,
                       torch.cat(flat1).sort().values)


def test_pack_keeps_the_backward_layout():
    """The bf16 pack keeps w0 (cout, 9 cin) and w1 (cout, 9 cout + cin),
    column (3 dy + dx) C + c, which the backward kernel reads; the fp32
    pack has no stages; the cached pointers are the tensors'."""
    rng = np.random.default_rng(6)
    p = resblock_params_torch(resblock_params(rng, 64, 128))
    for dtype in (torch.bfloat16, torch.float32):
        pk = frb.pack_resblock_params(p, dtype, "cpu")
        assert pk.w0.shape == (128, 9 * 64) and pk.w1.shape == (128, 9 * 128 + 64)
        for dy, dx, c in [(0, 0, 0), (1, 2, 33), (2, 1, 63)]:
            assert torch.equal(pk.w0[:, (3 * dy + dx) * 64 + c], p[2][:, c, dy, dx].to(dtype))
            assert torch.equal(pk.w1[:, (3 * dy + dx) * 128 + c], p[6][:, c, dy, dx].to(dtype))
        assert torch.equal(pk.w1[:, 9 * 128:], p[8].to(dtype))
        assert (pk.w0s is None) == (dtype == torch.float32)
        assert pk.ptrs[2] == pk.w0.data_ptr() and pk.ptrs[6] == pk.w1.data_ptr()
        assert pk.ptrs[8] == (0 if pk.w0s is None else pk.w0s.data_ptr())
    # channel counts the bf16 kernel does not take get no stages (its gate raises)
    small = frb.pack_resblock_params(resblock_params_torch(resblock_params(rng, 32, 32, False)),
                                     torch.bfloat16, "cpu")
    assert small.w0s is None and small.w1s is None


@pytest.fixture(scope="module")
def census():
    """(kernel, resample, H, c1, c2, cout) -> calls over one evaluation of the
    full-width CIFAR NCSN++ (configs/cifar10.yml), walked on the meta device
    with the blocks replaced by recorders of their input shapes."""
    seen = Counter()

    def block(self, x, temb):
        cout = self.Conv_0.out_channels
        if isinstance(x, tuple):
            n, H, _, c1 = x[0].shape
            c2 = x[1].shape[3]
            if self.has_proj and self.resample == "none":
                seen[("fused_resblock_cat", "none", H, c1, c2, cout)] += 1
            else:
                seen[("fused_resblock", self.resample, H, c1 + c2, 0, cout)] += 1
        else:
            n, H, _, c1 = x.shape
            seen[("fused_resblock", self.resample, H, c1, 0, cout)] += 1
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[self.resample]
        return torch.empty(n, Ho, Ho, cout, device="meta")

    mp = pytest.MonkeyPatch()
    mp.setattr(layers.ResnetBlockBigGANpp, "forward", block)
    mp.setattr(layers.AttnBlockpp, "forward", lambda self, x: x)
    try:
        with torch.device("meta"):
            model = ncsnpp_from_config(load_config("configs/cifar10.yml"), dtype=torch.bfloat16)
        model(torch.empty(2, 32, 32, 3, device="meta"), torch.empty(2, device="meta"))
    finally:
        mp.undo()
    return dict(seen)


def test_census_is_the_main_path(census):
    """40 plain and 36 concat block calls per evaluation at 17 shapes."""
    calls = Counter()
    for (name, *_), n in census.items():
        calls[name] += n
    assert calls == {"fused_resblock": 40, "fused_resblock_cat": 36} and len(census) == 17


def _slices(steps, splits, per):
    return [(z * per, min(steps, (z + 1) * per)) for z in range(splits)]


@pytest.mark.parametrize("batch", [8, 16, 128])
def test_resblock_plan_covers_the_census(census, batch):
    """At every census shape: a tile the kernel has; M tiles that cover the
    N Ho Wo rows once, each one TMA box of whole rows of one image or of
    whole images (the box may run past the last image, where TMA reads
    zeros and the epilogue stores nothing); K slices that cover each conv's
    steps in order; partials that fit the workspace; and a grid that fills
    its waves of 132 SMs to 90%, or splits K as far as its caps allow."""
    for (name, rs, H, c1, c2, cout), _ in sorted(census.items()):
        cin = c1 + c2
        proj = name == "fused_resblock_cat" or rs != "none" or cin != cout
        plan = frb.check_resblock_shape(torch.bfloat16, batch, H, H, c1, c2, cout, rs, proj,
                                        32, 32)
        Ho = {"none": H, "down": H // 2, "up": 2 * H}[rs]
        hw, M = Ho * Ho, batch * Ho * Ho
        assert (plan.bm, plan.bn) in frb.RB_TILES and cout % plan.bn == 0
        bw, bh, bimg = plan.box
        assert bw == Ho and bw * bh * bimg == plan.bm and max(plan.box) <= 256
        assert plan.mtiles == -(-M // plan.bm) and plan.ntiles == cout // plan.bn
        rows = set()
        for t in range(plan.mtiles):
            m0 = t * plan.bm
            if bimg > 1:
                assert bh == Ho and m0 % hw == 0
            else:
                assert m0 % hw + plan.bm <= hw and (m0 % hw) % Ho == 0
            rows.update(range(m0, min(M, m0 + plan.bm)))
        assert rows == set(range(M))
        assert plan.steps == (9 * cin // 64, 9 * cout // 64 + (cin // 64 if proj else 0))
        tiles = plan.mtiles * plan.ntiles
        fills = tiles / (-(-tiles // 132) * 132) >= frb.RB_MIN_FILL
        for steps, splits, per in zip(plan.steps, plan.splits, plan.per):
            cuts = _slices(steps, splits, per)
            assert cuts[0][0] == 0 and cuts[-1][1] == steps
            assert all(a < b for a, b in cuts) and all(
                cuts[i][1] == cuts[i + 1][0] for i in range(len(cuts) - 1))
            if splits > 1:
                assert splits * M * cout <= _cuda.SPLITK_WORKSPACE
            if fills:
                assert splits == 1
            else:
                assert tiles * splits <= 132 and (
                    tiles * splits >= frb.RB_MIN_FILL * 132 or per <= 2 * frb.RB_MIN_STEPS
                    or splits * M * cout * 2 > _cuda.SPLITK_WORKSPACE
                    or 132 // tiles <= splits)


@pytest.mark.parametrize("c1,c2,cout,match", [
    (96, 0, 128, "multiples of 64"), (128, 32, 128, "multiples of 64"),
    (128, 0, 96, "multiples of 64"), (128, 0, 200, "multiples of 64")])
def test_shape_gate_raises_off_multiples_of_64(c1, c2, cout, match):
    with pytest.raises(ValueError, match=match):
        frb.check_resblock_shape(torch.bfloat16, 8, 16, 16, c1, c2, cout, "none", True, 8, 8)


@pytest.mark.parametrize("c1,c2,cout,g1,g2", [
    (1088, 0, 128, 32, 32), (512, 576, 256, 32, 32), (128, 0, 1088, 32, 32),
    (256, 0, 256, 128, 32), (256, 0, 256, 32, 128), (192, 0, 128, 40, 32),
    (128, 0, 192, 32, 40)])
def test_shape_gate_raises_past_the_gn_pass(c1, c2, cout, g1, g2):
    """More channels or groups than the GroupNorm pass's scratch holds, or
    groups that do not divide the channels: refused in Python, before the
    C side would refuse them."""
    with pytest.raises(ValueError, match="GroupNorm pass"):
        frb.check_resblock_shape(torch.bfloat16, 8, 16, 16, c1, c2, cout, "none", True,
                                 g1, g2)


@pytest.mark.parametrize("H,W", [(12, 12), (6, 6), (16, 24)])
def test_shape_gate_raises_where_no_box_tiles_the_map(H, W):
    with pytest.raises(ValueError, match="boxes do not tile"):
        frb.check_resblock_shape(torch.bfloat16, 8, H, W, 128, 0, 128, "none", False, 32, 32)


def test_shape_gate_takes_the_census_and_leaves_fp32_alone(census):
    for (name, rs, H, c1, c2, cout), _ in census.items():
        for batch in (1, 2, 8, 16, 128):
            assert frb.check_resblock_shape(torch.bfloat16, batch, H, H, c1, c2, cout, rs,
                                            True, 32, 32) is not None
            assert frb.check_resblock_shape(torch.float32, batch, H, H, c1, c2, cout, rs,
                                            True, 32, 32) is None


@pytest.mark.parametrize("rs,H", [("up", 16), ("down", 16), ("up", 4), ("down", 32)])
def test_shape_gate_takes_identity_skip_resampling(rs, H):
    """An up or down block with an identity skip (cin == cout, no
    projection; the skip is the resampled x) has a plan on the output
    grid, with conv1's K steps the 3x3 conv's alone."""
    Ho = {"up": 2 * H, "down": H // 2}[rs]
    plan = frb.check_resblock_shape(torch.bfloat16, 8, H, H, 128, 0, 128, rs, False, 32, 32)
    assert plan.box[0] == Ho and plan.mtiles * plan.bm >= 8 * Ho * Ho
    assert plan.steps == (9 * 128 // 64, 9 * 128 // 64)


def test_resblock_has_no_route_off_the_cpu_but_the_kernel():
    """A tensor on neither the CPU nor a card is refused before any launch,
    for both block forms; no other device reaches the plain version."""
    rng = np.random.default_rng(7)
    p = resblock_params_torch(resblock_params(rng, 64, 64))
    x = torch.empty(1, 4, 4, 64, device="meta", dtype=torch.bfloat16)
    launches = frb.fused_resblock.launches, frb.fused_resblock_cat.launches
    with pytest.raises(ValueError, match="cpu or cuda"):
        frb.fused_resblock(x, torch.zeros(1, 64), p, num_groups1=16, num_groups2=16)
    with pytest.raises(ValueError, match="cpu or cuda"):
        frb.fused_resblock_cat(x[..., :32], x[..., 32:], torch.zeros(1, 64), p,
                               num_groups1=16, num_groups2=16)
    assert (frb.fused_resblock.launches, frb.fused_resblock_cat.launches) == launches


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1024, 256, 1000])
@pytest.mark.parametrize("D", [64, 32, 128])
def test_adm_attention_route(dtype, T, D):
    """The ADM attention block takes the flash kernel by JAX's gate alone
    (T >= 1024 tokens) on a CUDA tensor, else the dense qkv_attention on
    any head width; on the flash route a (T, D) the kernel does not take
    raises rather than running the dense path on the card."""
    route = attention_route(True, T, "cuda")
    assert route == ("flash" if T >= 1024 else "dense")
    assert attention_route(True, T, "cpu") == "dense"
    assert attention_route(False, T, "cuda") == "dense"
    if route == "flash" and D != 64:
        with pytest.raises(ValueError, match="D == 64"):
            check_flash_shape(dtype, T, D)
    elif route == "flash":
        check_flash_shape(dtype, T, D)
