"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), linked into one shared library
with a plain C interface, and loaded with :mod:`ctypes`.  The build runs at
first use, into ``build/repro_torch_kernels/<hash>/`` at the root of the
checkout, keyed on a hash of the sources and the flags, so a fresh checkout
builds everything on its first call and a changed source rebuilds.

``-fmad=false`` keeps ``nvcc`` from contracting a product and a sum into a
fused multiply-add on its own: the kernels write every fma they mean
(``fma`` in csrc/simplex_pivot.cu, ``fmaf`` in the attention, SSD and
RMSNorm kernels), so their rounding is the source's.

Nothing here falls back: a missing toolkit, a failed compile or a library
that does not load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["library", "build_seconds", "SOURCE_DIR", "BUILD_ROOT"]

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_SECONDS: float | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # T, basis, it, status, lanes, n_lanes, R, C, ncols_price, bland_after,
    # max_iter, k_pivots, stream
    "repro_simplex_pivot": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # w, z, latency, tau, vcomm, vcomp, rel, ret, valid, gamma,
    # cs, ce, ps, pe, rs, re, mk, B, m, T, star, stream
    "repro_asap_replay": [_P] * 17 + [_I, _I, _I, _I, _P],
    # q, k, v, o, B, H, KVH, Sq, Sk, D, bf16, strides of q, k/v and o (b, s, h),
    # causal, window, scale, stream
    "repro_flash_attention": [_P] * 4 + [_I] * 7 + [_L] * 9 + [_I, _I, _F, _P],
    # q, k_cache, v_cache, cache_len, part_m, part_l, part_acc, o, B, H, KVH,
    # Smax, D, bf16, strides q (b, h), caches (b, s, h), o (b, h), window,
    # scale, stream
    "repro_decode_attention": [_P] * 8 + [_I] * 6 + [_L] * 7 + [_I, _F, _P],
    "repro_decode_attention_chunk": [],
    # x, dt, A, B, C, D, y, B, S, H, G, P, N, L, bf16, strides of x, dt, B, C
    # and y (b, s, h or g), stream
    "repro_ssd_scan": [_P] * 7 + [_I] * 8 + [_L] * 15 + [_P],
    # x, w, out, rows, D, row strides of x and out, bf16, eps, stream
    "repro_rms_norm": [_P, _P, _P, _I, _I, _L, _L, _I, _F, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and under CUDA_HOME); the port's "
            "CUDA kernels are built from source at first use")
    return str(path)


def _sources() -> list[Path]:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path, sources: list[Path]) -> None:
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        objs = [Path(tmp) / (s.stem + ".o") for s in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(sources, objs)
        ]
        errors = []
        for src, proc in zip(sources, procs):
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
        lib = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(lib), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, out)  # atomic: a concurrent loader sees all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _LIB, _BUILD_SECONDS
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = _sources()
        out = BUILD_ROOT / _digest() / "librepro_torch_kernels.so"
        t0 = time.perf_counter()
        if not out.exists():
            _compile(out, sources)
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _BUILD_SECONDS = time.perf_counter() - t0
        _LIB = lib
        return lib


def build_seconds() -> float | None:
    """Seconds the first :func:`library` call took (compile + load), or
    None before it ran."""
    return _BUILD_SECONDS


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code (``cudaGetLastError``
    right after the launch, as the C functions return it)."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
