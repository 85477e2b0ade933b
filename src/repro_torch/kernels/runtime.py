"""Build, load and count the port's CUDA kernels.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, then linked into one
shared library with a plain C interface:
``build/kernels/<hash of the sources>/librepro_torch_kernels.so`` at the
root of the checkout.  It is loaded with ``ctypes``.  Nothing is built
or loaded at import: the first kernel launch builds, so the CPU tests
import every module without ``nvcc``.

Each wrapper adds one to ``launch_counts[<kernel>]`` where it launches
its kernel and nowhere else (the int8 decode variants count as kernels
of their own, ``flash_decode_int8`` and ``paged_flash_decode_int8``); the prefill wrapper also adds one to
``prefill_body_counts[<body>]`` for the body that launch ran
(``kernels/flash_prefill.py:body``), and to
``prefill_unaligned_counts[<body>]`` when the launch's ``q_offset`` is
positive and not a multiple of ``PREFILL_TILE`` (a chunk resumed inside
a query tile, as after a session hit; ``count_unaligned``: at an offset
held in a device tensor the engine counts it from the host ``start``).
``grouped_counts`` counts the MoE's grouped products on the card by
route (``models/moe.py:grouped_mm``: the library's grouped GEMM for
bf16, the plain masked loop for f32); they are no kernels of the port,
so they stay out of ``launch_counts``.  ``autograd_counts`` counts the
backward passes of calls made under autograd (``kernels/autograd.py``:
a kernel's plain version re-run, for ``flash_prefill``; ``models/moe.py``:
the bf16 grouped product's own backward); the forward launches count in
``launch_counts`` as in serving, and so does ``wkv6``'s backward kernel
(``wkv6_bwd``).  ``lse_counts`` counts the contiguous decode launches that
also wrote their log-sum-exp output (``lse_out``, the local body of the
sequence-sharded decode).  ``reset_launch_counts`` zeroes all six.  ``decode_plans`` holds the grid and body of each decode
kernel's last launch (``kernels/decode_attn.py:plan``); the reset
clears it.  A replayed CUDA graph runs no wrapper:
``core/engine.py:DecodeGraph`` reads what its capture added to the
counts and plans (``count_state``), puts them back as they were, and
adds the capture's share again at every replay (``add_counts``).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("flash_prefill.cu", "decode_attn.cu", "paged_decode_attn.cu",
           "wkv6.cu", "wkv6_bwd.cu")
HEADERS = ("common.cuh", "decode_common.cuh", "hopper.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LIB_NAME = "librepro_torch_kernels.so"

# dtype codes of csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

KERNELS = ("flash_prefill", "paged_flash_decode", "flash_decode", "wkv6",
           "paged_flash_decode_int8", "flash_decode_int8", "wkv6_bwd")
# the decode kernels, each with a decode plan
DECODE_KERNELS = ("flash_decode", "paged_flash_decode", "flash_decode_int8",
                  "paged_flash_decode_int8")
launch_counts = {name: 0 for name in KERNELS}
# the two bodies of csrc/flash_prefill.cu
PREFILL_BODIES = ("tensor_core", "cuda_core")
prefill_body_counts = {name: 0 for name in PREFILL_BODIES}
# query rows a block of the tensor-core prefill body
PREFILL_TILE = 64
prefill_unaligned_counts = {name: 0 for name in PREFILL_BODIES}


# kernel -> decode_attn.DecodePlan of its last launch
decode_plans = {name: None for name in DECODE_KERNELS}


# the MoE's grouped products on the card, by route (models/moe.py)
grouped_counts = {"grouped_mm": 0, "masked_loop": 0}


# the contiguous decode kernels' launches that also wrote the
# log-sum-exp output (lse_out; counted in launch_counts as well)
lse_counts = {"flash_decode": 0, "flash_decode_int8": 0}


# backward passes through the plain versions of the kernels launched
# under autograd (kernels/autograd.py: flash_prefill; wkv6's backward is
# its own kernel, wkv6_bwd, counted in launch_counts), and of the bf16
# grouped product (models/moe.py)
autograd_counts = {"flash_prefill": 0, "grouped_mm": 0}


COUNTERS = (launch_counts, prefill_body_counts, prefill_unaligned_counts,
            grouped_counts, autograd_counts, lse_counts)


def count_unaligned(q_offset: int, bodies) -> None:
    """Add ``bodies`` ({body: launches}) to ``prefill_unaligned_counts``
    when ``q_offset`` is positive and off the ``PREFILL_TILE`` grid."""
    if q_offset > 0 and q_offset % PREFILL_TILE:
        for b, n in bodies.items():
            prefill_unaligned_counts[b] += n


def reset_launch_counts() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0
    for name in decode_plans:
        decode_plans[name] = None


def count_state():
    """A copy of every count of ``COUNTERS`` and of ``decode_plans``."""
    return tuple(dict(c) for c in COUNTERS), dict(decode_plans)


def set_count_state(state) -> None:
    """Put back a ``count_state``."""
    counts, plans = state
    for c, saved in zip(COUNTERS, counts):
        c.update(saved)
    decode_plans.update(plans)


def add_counts(state) -> None:
    """Add the counts of a ``count_state`` to the live ones, and set the
    plans it holds (those that are not None)."""
    counts, plans = state
    for c, add in zip(COUNTERS, counts):
        for name, n in add.items():
            c[name] += n
    decode_plans.update({k: p for k, p in plans.items() if p is not None})


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card")


def cuda_tool(name: str) -> Path:
    """A tool of the toolkit that builds the kernels (``cuobjdump``)."""
    return Path(_nvcc()).parent / name


def _source_hash(sources, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in tuple(sources) + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(sources=SOURCES, defines=()) -> Path:
    """Compile ``sources`` (in parallel, with ``-D`` of each of
    ``defines``) and link the shared library; returns its path.  A
    library already built from the same sources and flags is reused."""
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    out = BUILD_ROOT / _source_hash(sources, flags) / LIB_NAME
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in sources:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *flags, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        objs, errors = [], []
        for name, obj, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{name}:\n{log}")
            objs.append(str(obj))
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *flags, "-shared", *objs, "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, out)
    return out


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # q, k, v, lengths, out, B, Tq, Tk, H, Hkv, Dh, causal, window,
    # q_offset (device int32; null: 0), dtype, stream
    "rt_flash_prefill": [_P] * 5 + [_I] * 8 + [_P, _I, _P],
    # dtype, Dh -> 1 for the tensor-core body, 0 for the CUDA-core body
    "rt_flash_prefill_body": [_I] * 2,
    # q, k, v, pos, out, lse (null: none), part, arrivals, B, S, H, Hkv,
    # Dh, ring, L, n_split, dtype, stream
    "rt_flash_decode": [_P] * 8 + [_I] * 9 + [_P],
    # q, kp, vp, block_tables, pos, out, part, arrivals, B, n_pages, page,
    # n_p, s_len, H, Hkv, Dh, ring, L, n_split, dtype, stream
    "rt_paged_flash_decode": [_P] * 8 + [_I] * 12 + [_P],
    # q, k codes, v codes, k scales, v scales, pos, out, lse, part,
    # arrivals, then as rt_flash_decode
    "rt_flash_decode_int8": [_P] * 10 + [_I] * 9 + [_P],
    # q, kp, vp, k scales, v scales, block_tables, pos, out, part,
    # arrivals, then as rt_paged_flash_decode
    "rt_paged_flash_decode_int8": [_P] * 10 + [_I] * 12 + [_P],
    # dtype, Dh -> 1 for the tensor-core body, 0 for the CUDA-core body
    "rt_decode_body": [_I] * 2,
    # r, k, v, w, u, s0, y, sT, B, T, H, hs, dtype, stream
    "rt_wkv6": [_P] * 8 + [_I] * 5 + [_P],
    # the same, then kr, vc, cols (a given tile), stream
    "rt_wkv6_tile": [_P] * 8 + [_I] * 8 + [_P],
    # B, H, hs, T, out[3] -> the tile rt_wkv6 launches (kr, vc, cols)
    "rt_wkv6_plan": [_I] * 4 + [_P],
    # r, k, v, w, u, s0, dy, dsT (null: zero), dr, dk, dv, dw, du, ds0,
    # ckpt, du_part, B, T, H, hs, dtype, stream
    "rt_wkv6_bwd": [_P] * 16 + [_I] * 5 + [_P],
}


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


_arrivals: dict = {}
_arrival_store = None       # a graph's own buffers while it is captured


@contextlib.contextmanager
def own_arrivals(store: dict):
    """Inside the block, ``arrival_counters`` keeps its buffers in
    ``store`` instead of the per-device ones.  A CUDA graph holds the
    pointer it captured for its lifetime; the per-device buffer is
    replaced when a call needs more, so a graph captures over a store of
    its own (``core/engine.py:DecodeGraph``)."""
    global _arrival_store
    prev, _arrival_store = _arrival_store, store
    try:
        yield
    finally:
        _arrival_store = prev


def arrival_counters(device: torch.device, n: int) -> torch.Tensor:
    """The decode kernels' int32 arrival counters, one per (row, kv head),
    zero between launches (the last block of each group resets its own).
    Allocated zeroed once per device (or per ``own_arrivals`` store) and
    grown when a call needs more; launches on one stream use them in
    turn."""
    store = _arrivals if _arrival_store is None else _arrival_store
    buf = store.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        store[device] = buf
    return buf


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


CUDA_ERROR_INVALID_VALUE = 1


def check(err: int, kernel: str, shape: str) -> None:
    """Raise if the launch returned a CUDA error code.  The C launch is
    the one place that holds each kernel's limits (supported Dh: 64, 80,
    128, 192 and 256; for the decode kernels G * Dh at most 2048, or 3072
    at Dh 192 and 4096 at Dh 256, that is G <= 16 there; table coverage): it returns cudaErrorInvalidValue for a shape
    outside them without launching."""
    if err == CUDA_ERROR_INVALID_VALUE:
        raise ValueError(f"{kernel}: shape not supported by the kernel "
                         f"({shape})")
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} "
                           f"({shape})")


def check_operands(kernel: str, *tensors: torch.Tensor,
                   dtype: torch.dtype | None = None) -> None:
    """Every operand on one CUDA device, contiguous and 16-byte aligned
    (the kernels read K/V rows with 16-byte loads); float operands share
    ``dtype`` (one of ``DTYPE_CODES``)."""
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{kernel}: operands must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: operands must be 16-byte aligned")
    if dtype is not None and dtype not in DTYPE_CODES:
        raise ValueError(f"{kernel}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
