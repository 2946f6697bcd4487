"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes`` (no PyTorch headers,
so a build takes seconds). The build happens at the first kernel launch of a
process, into ``diffpure_tpu_torch/_build/`` (git-ignored), under a name
derived from the sources' contents, so a changed source is rebuilt and an
unchanged one is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def build() -> Path:
    """Compile csrc/*.cu (in parallel) and link the shared library; return
    its path. The compiler's report (-Xptxas -v) goes to _build/build.log."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"libdiffpure_kernels_{tag}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in sources:
        obj = BUILD_DIR / f"{src.stem}_{tag}.o"
        proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((src, obj, proc))
    log = []
    for src, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib_path)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    return lib_path


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_long, ctypes.c_float
    lib.diffpure_resblock_fwd.argtypes = [
        I, P, P, I, I, I, I, I, I, P,     # dtype, x1, x2, c1, c2, N, H, W, resample, temb
        P, P, I, P, P,                    # gn1s, gn1b, g1, w0, b0
        P, P, I, P, P, I, I,              # gn2s, gn2b, g2, w1, bias1, has_proj, cout
        F, F, P, P, P, P,                 # eps, oscale, act1, xs, h1, act2
        P, L, P, P, P,                    # ws, ws_elems, out, w0s, w1s
        P, P]                             # plan (8 ints), stream
    lib.diffpure_resblock_fwd.restype = I
    lib.diffpure_f32conv.argtypes = [
        P, I, I, I, I, P, I,              # act, N, H, W, C, w, cout
        P, P, L, I, I, I, I, I, P]        # out, ws, ws_elems, tn, stages, splits, per, ablate, stream
    lib.diffpure_f32conv.restype = I
    lib.diffpure_resblock_bwd.argtypes = [
        I, P, P, I, I, I, I, I, I, P, P,  # dtype, x1, x2, c1, c2, N, H, W, resample, temb, g
        P, P, I, P, P,                    # gn1s, gn1b, g1, w0, b0
        P, P, I, P, P, P, I,              # gn2s, gn2b, g2, w1t, w0t, wskipt, cout
        F, F, P, P, P, P, P, P,           # eps, oscale, act1, h1, da2, dc1, dh, dskip
        P, L, P, P, P,                    # ws, ws_elems, dx1, dx2, dtemb
        P, P, P, P,                       # w0s, w1ts, w0ts, wskipts
        P, P, P]                          # gn1_stats, plan, stream
    lib.diffpure_resblock_bwd.restype = I
    lib.diffpure_attnblock_fwd.argtypes = [
        I, P, I, I, I, I,                 # dtype, x, N, H, W, C
        P, P, I, P, P, P, P,              # gns, gnb, G, wqkv, bqkv, wo, bo
        F, F, P, P,                       # eps, oscale, h, qkv
        P, L, P, P, P, P, P]              # ws, ws_elems, out, wqkvs, wos, plan, stream
    lib.diffpure_attnblock_fwd.restype = I
    lib.diffpure_group_stats.argtypes = [
        I, P, I, I, I, I, I, P, P, P]     # dtype, x, N, H, W, C, rows, sums, sqs, stream
    lib.diffpure_group_stats.restype = I
    lib.diffpure_gn_apply.argtypes = [
        I, P, P, P, I, I, I, I, I, P, P]  # dtype, x, A, B, N, H, W, C, silu, out, stream
    lib.diffpure_gn_apply.restype = I
    lib.diffpure_halo_conv.argtypes = [
        I, P, I, I, I, I, P, P,           # dtype, x, N, H, W, cin, A, B
        P, P, P, I, P, I, P,              # w, bias, skip, cr, wproj, cout, out
        I, I, P]                          # tile_rows, tile_n, stream
    lib.diffpure_halo_conv.restype = I
    lib.diffpure_flash_attention.argtypes = [
        I, P, P, P, I, I, I, I, F, P, P]  # dtype, q, k, v, BH, T, D, dt, sm_scale, out, stream
    lib.diffpure_flash_attention.restype = I
    lib.diffpure_gn_silu.argtypes = [
        I, P, P, P, I, I, I, I, F, P,     # dtype, x, gamma, beta, N, HW, C, G, eps, out
        P, P]                             # plan, stream
    lib.diffpure_gn_silu.restype = I
    lib.diffpure_fused_leaky_relu.argtypes = [
        I, P, P, L, I, F, F, P,           # dtype, x, bias, total, C, slope, scale, out
        P, P]                             # plan (6 ints), stream
    lib.diffpure_fused_leaky_relu.restype = I
    lib.diffpure_error_string.argtypes = [I]
    lib.diffpure_error_string.restype = ctypes.c_char_p
    return lib


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(str(build())))
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = lib().diffpure_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# fp32 elements of the split-K partials' scratch every launch gets. The
# kernels split a GEMM only as far as its partials fit (16 MB covers every
# NCSN++ block whose grid is small enough to split, at batch 8).
SPLITK_WORKSPACE = 1 << 22


def scratch(device, *nbytes: int):
    """One allocation holding buffers of the given sizes (256-byte aligned)
    followed by the split-K workspace: (tensor that owns it, the buffers'
    addresses, the workspace's address). One call to the caching allocator
    instead of one per buffer: the wrappers run thousands of times per
    purification, and the host time per call bounds small maps."""
    offsets, total = [], 0
    for n in nbytes:
        offsets.append(total)
        total += (n + 255) // 256 * 256
    buf = torch.empty(total + 4 * SPLITK_WORKSPACE, device=device, dtype=torch.uint8)
    base = buf.data_ptr()
    return buf, [base + o for o in offsets], base + total


def check_device(what: str, t: torch.Tensor) -> None:
    """The wrappers take CPU tensors (plain version) or CUDA ones (kernel)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {t.device}")


def autograd_vjp(reference):
    """The vector-Jacobian product of ``reference(cfg, *tensors)`` by
    autograd, recomputed from the inputs: the backward of JAX's
    ``custom_vjp`` wrappers of the 256-px kernels and of #10 (``jax.vjp`` of
    the plain version). Returns vjp(cfg, need, tensors, grads) -> a
    gradient for each input whose ``need`` is set, else None."""
    def vjp(cfg, need, tensors, grads):
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(tensors, need)]
            out = reference(cfg, *leaves)
            outs = out if isinstance(out, tuple) else (out,)
            wanted = [t for t, n in zip(leaves, need) if n]
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        res = []
        for t, n in zip(leaves, need):
            g = next(got) if n else None
            res.append(torch.zeros_like(t) if n and g is None else g)
        return tuple(res)
    return vjp


class KernelFunction(torch.autograd.Function):
    """A kernel with the gradient of its plain version, at the granularity
    of a JAX ``custom_vjp``: ``apply((kernel, plain, vjp), cfg, *tensors)``.
    The forward runs ``kernel(cfg, *tensors)`` on CUDA tensors and
    ``plain(cfg, *tensors)`` on CPU tensors (one ``Function`` either way, so
    the CPU tests reach the backward) and saves only its inputs (None for an
    absent one); the backward is ``vjp(cfg, need, inputs, grads)``, most
    often ``autograd_vjp`` of the plain version. ``cfg`` holds the
    non-tensor arguments (group count, eps, weight packs)."""

    @staticmethod
    def forward(ctx, fns, cfg, *tensors):
        ctx.fns, ctx.cfg = fns, cfg
        ctx.save_for_backward(*tensors)
        kernel, plain, _ = fns
        return (plain if tensors[0].device.type == "cpu" else kernel)(cfg, *tensors)

    @staticmethod
    def backward(ctx, *grads):
        vjp = ctx.fns[2]
        return (None, None, *vjp(ctx.cfg, ctx.needs_input_grad[2:], ctx.saved_tensors,
                                 grads))


_sms = {}


def num_sms(device) -> int:
    """The card's streaming multiprocessor count (the halo plan fills it)."""
    idx = torch.device(device).index or 0
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_operand(t: torch.Tensor, name: str, device: torch.device,
                  dtype: torch.dtype, shape=None) -> int:
    """Validate a kernel operand and return its device pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} is too large for 32-bit indexing")
    return t.data_ptr()

