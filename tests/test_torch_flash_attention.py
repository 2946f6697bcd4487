"""The port's flash attention (plain version on the CPU) and dense
qkv_attention against diffpure_tpu's, its Pallas kernel in interpret mode,
on the same seeded inputs, fp32 and bf16, at each head width the card's
kernel is built for, and through the wrapper's zero padding at widths it
is not built for."""
import numpy as np
import pytest
import torch

from diffpure_tpu.ops import flash_attention as jfa
from diffpure_tpu.ops.attention import qkv_attention as jax_qkv_attention
from diffpure_tpu_torch.ops import flash_attention as fa
from diffpure_tpu_torch.ops.attention import qkv_attention
from torch_parity import DTYPES, REL, assert_close, normal, to_jax, to_torch

T = 256
WIDTHS = (32, 64, 128)  # head widths the kernel is built for
# Widths the wrapper pads to the next built one (16 -> 32, 48 -> 64, 96 ->
# 128, 160 -> 256), and 256, the widest, built and unpadded.
PADDED_WIDTHS = (16, 48, 96, 160, 256)
# Padded plain version against JAX's kernel: fp32 differs by summation
# order and the online softmax's rescaling only (the zero channels add
# exactly 0); bf16 by the output's rounding.
PAD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


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


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", PADDED_WIDTHS)
def test_padded_heads_match_jax_kernel(dtype, D):
    """The wrapper's pad-and-slice at T = 128: q, k and v zero-padded along D
    to flash_width(D), the plain version on them, sliced back to D
    channels, against JAX's flash kernel at D (interpret mode)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    q, k, v = (normal(rng, 2, 128, D) for _ in range(3))
    scale = 1.0 / D ** 0.25
    width = fa.flash_width(D)
    assert width == min(w for w in fa.FLASH_WIDTHS if w >= D)
    padded = [fa.pad_heads(to_torch(t, tdt), width) for t in (q, k, v)]
    for t, p in zip((q, k, v), padded):
        assert p.shape == (2, 128, width) and p.dtype == tdt
        assert torch.equal(p[..., :D], to_torch(t, tdt)) and not p[..., D:].any()
    got = fa._reference_attention(*padded, scale)[..., :D]
    want = jfa.flash_attention(to_jax(q, jdt), to_jax(k, jdt), to_jax(v, jdt), scale,
                               interpret=True)
    assert_close(got, want, PAD_REL[dtype], f"padded flash D={D} {dtype}")


@pytest.mark.parametrize("dtype,D,held", [
    (torch.bfloat16, 64, 64), (torch.float32, 64, 64), (torch.float32, 256, 256),
    (torch.bfloat16, 16, 16), (torch.bfloat16, 48, 48), (torch.bfloat16, 96, 96),
    (torch.bfloat16, 160, 160), (torch.bfloat16, 36, 64), (torch.bfloat16, 1, 32),
    (torch.float32, 16, 32), (torch.float32, 48, 64), (torch.float32, 160, 256),
])
def test_operand_width(dtype, D, held):
    """What the launch passes: bf16 heads with D % 8 == 0 as they are (the
    kernel's tensor maps read zeros past D), others zero-padded to
    flash_width(D), and the built widths as they are in both dtypes."""
    assert fa.operand_width(dtype, D) == held
    assert held in (D, fa.flash_width(D))


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
    (torch.bfloat16, 1024, 96, True), (torch.float32, 1024, 96, True),
    (torch.bfloat16, 1024, 48, True), (torch.float32, 1024, 48, True),
    (torch.bfloat16, 192, 32, False), (torch.float32, 96, 128, False),
    (torch.bfloat16, 1024, 256, True), (torch.float32, 1024, 256, True),
    (torch.bfloat16, 1024, 1, True), (torch.float32, 1024, 160, True),
    (torch.bfloat16, 1024, 257, False), (torch.float32, 1024, 257, False),
    (torch.bfloat16, 1024, 0, False), (torch.float32, 192, 256, True),
])
def test_flash_shape_gate(dtype, T, D, ok):
    """The kernel's gate: 1 <= D <= 256 (a width it is not built for runs
    on the next built one), T a multiple of 128 (bf16) or 64
    (fp32); D = 257 and a T off the block raise before a launch."""
    if ok:
        assert fa.check_flash_shape(dtype, T, D) == fa.flash_width(D) >= D
    else:
        with pytest.raises(ValueError, match=r"1 <= D <= 256 and T %"):
            fa.check_flash_shape(dtype, T, D)
