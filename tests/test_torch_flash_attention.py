"""The port's flash attention (plain version on the CPU) and dense
qkv_attention against diffpure_tpu's, its Pallas kernel in interpret mode,
on the same seeded inputs, fp32 and bf16, at each head width the card's
kernel takes."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops import flash_attention as jfa
from diffpure_tpu.ops.attention import qkv_attention as jax_qkv_attention
from diffpure_tpu_torch.ops import flash_attention as fa
from diffpure_tpu_torch.ops.attention import qkv_attention
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

T = 256
WIDTHS = (32, 64, 128)  # the head widths the kernel takes


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", WIDTHS)
def test_flash_attention_matches_jax_kernel(dtype, D):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (normal(rng, 4, T, D) for _ in range(3))
    scale = 1.0 / D ** 0.25
    want = jfa.flash_attention(to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt), scale,
                               interpret=True)
    got = fa.flash_attention(to_torch(q, tdt), to_torch(k, tdt), to_torch(v, tdt), scale)
    assert got.dtype == tdt
    assert_close(got, want, REL[dtype], f"flash {dtype}")
    ref = jfa._reference_attention(to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt), scale)
    assert_close(fa._reference_attention(to_torch(q, tdt), to_torch(k, tdt),
                                         to_torch(v, tdt), scale), ref, REL[dtype], "reference")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("order", ["legacy", "new"])
@pytest.mark.parametrize("D", WIDTHS)
def test_qkv_attention_both_forms_match_jax(dtype, order, D):
    jdt, tdt = DTYPES[dtype]
    heads = 2
    qkv = normal(np.random.default_rng(1), 2, T, 3 * heads * D)
    want = jfa.qkv_flash_attention(to_jax(qkv, jdt), heads, order=order, interpret=True)
    got = fa.qkv_flash_attention(to_torch(qkv, tdt), heads, order=order)
    assert got.shape == (2, T, heads * D)
    assert_close(got, want, REL[dtype], f"qkv flash {order} {dtype}")
    want = jax_qkv_attention(to_jax(qkv, jdt), heads, order=order)
    got = qkv_attention(to_torch(qkv, tdt), heads, order=order)
    assert_close(got, want, REL[dtype], f"dense qkv {order} {dtype}")


def test_flash_attention_has_no_fallback_off_the_cpu():
    q = torch.empty(2, 64, 64, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention(q, q, q, 0.5)


@pytest.mark.parametrize("dtype,T,D,ok", [
    (torch.bfloat16, 1024, 64, True), (torch.float32, 1024, 64, True),
    (torch.bfloat16, 256, 64, True), (torch.float32, 192, 64, True),
    (torch.bfloat16, 192, 64, False), (torch.float32, 96, 64, False),
    (torch.bfloat16, 1024, 32, True), (torch.float32, 1024, 128, True),
    (torch.bfloat16, 1024, 128, True), (torch.float32, 1024, 32, True),
    (torch.bfloat16, 1024, 96, False), (torch.float32, 1024, 96, False),
    (torch.bfloat16, 1024, 48, False), (torch.float32, 1024, 48, False),
    (torch.bfloat16, 192, 32, False), (torch.float32, 96, 128, False),
])
def test_flash_shape_gate(dtype, T, D, ok):
    """The kernel's gate: D in (32, 64, 128), T a multiple of 128 (bf16) or
    64 (fp32); the ADM-256 shape (T = 1024) passes in both dtypes at each
    of the three widths, and any other width raises before a launch."""
    if ok:
        fa.check_flash_shape(dtype, T, D)
    else:
        with pytest.raises(ValueError, match=r"D in \(32, 64, 128\)"):
            fa.check_flash_shape(dtype, T, D)
