"""Build, load and launch-count the hand-written CUDA kernels (`csrc/*.cu`).

The sources compile with nvcc for `sm_90a` into one shared library with a
plain C interface, loaded with ctypes. The build runs at first use, into
`_build/` beside `csrc/` (or `$GS_TORCH_BUILD_DIR`), and is reused while the
sources and flags are unchanged. Nothing here runs at import: the CPU tests
import every module on machines without nvcc or a card.

Each kernel wrapper adds one to `LAUNCHES[<name>]` where it launches its
kernel and nowhere else, so a run can show that the frame went through the
kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(os.environ.get("GS_TORCH_BUILD_DIR", CSRC.parent / "_build"))

# No --use_fast_math (logf/expf/sqrtf stay accurate) and no multiply-add
# contraction, so the kernels round like their plain torch versions.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "--fmad=false"]

LAUNCHES = {"fused": 0, "sort": 0, "composite": 0}
# Seconds the last build in this process took (None: no build ran).
build_seconds = None

_lib = None
_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gs_fused_frontend": [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(_I)] + [_P] * 8,
    "gs_sort_num_blocks": [ctypes.c_longlong],
    "gs_sort_count_live": [_P, ctypes.c_longlong, _P, _P, _P],
    "gs_sort_compact_radix": [_P, ctypes.c_longlong, _P, _P, _P, _I, _P, _P, _P],
    "gs_sort_tile_edges": [_P, _I, _I, _I, _P, _P],
    "gs_composite": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (set CUDA_HOME)")


def _build() -> Path:
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(CSRC.glob("*.cuh")):
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"libgs_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs = [BUILD_DIR / f"{src.stem}_{tag}.o" for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    failed = [(src.name, p.communicate()[0]) for src, p in zip(sources, procs)]
    failed = [(name, log) for (name, log), p in zip(failed, procs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{log}" for n, log in failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    build_seconds = time.perf_counter() - t0
    return out


def library():
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _I
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ptr(t):
    """Device pointer of a tensor (None -> NULL)."""
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype, shape: tuple) -> None:
    """Check that `t` is a contiguous CUDA tensor of `dtype` and `shape`."""
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}")
