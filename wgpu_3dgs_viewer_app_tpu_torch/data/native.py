"""ctypes bridge to the port's gsnative C++ codec (`native/gsnative.cpp`).

`pack_gaussians_native` is the fused counterpart of `compression.
pack_gaussians`'s numpy path: one multithreaded C pass doing the colour and
opacity quantisation, the SH reorder and compression, and the cov3d
construction, with the outputs of `wgpu_3dgs_viewer_app_tpu.data.native`
(the flat raw pod: f16 and u8 dtypes where compressed).

The library is built at first use (`native/build.py`). Where the machine
has no C++ compiler, `available()` is False and the callers pack with
numpy; where it has one and the build fails, the failure is raised.
"""

from __future__ import annotations

import ctypes
import threading
import time

import numpy as np

from .compression import Compressions, Cov3dCompression, ShCompression
from .gaussian import Gaussians

_SH_MODE = {
    ShCompression.SINGLE: 0,
    ShCompression.HALF: 1,
    ShCompression.NORM8: 2,
    ShCompression.REMOVE: 3,
}
_COV_MODE = {Cov3dCompression.SINGLE: 0, Cov3dCompression.HALF: 1}
_SH_DTYPE = {ShCompression.SINGLE: np.float32, ShCompression.HALF: np.float16,
             ShCompression.NORM8: np.uint8}

_lib = None
_lock = threading.Lock()
# Seconds the first use in this process took to build (or find) and load the
# library; None until then.
build_seconds = None


def _load():
    """The codec library, built and loaded on first use; None where the
    machine has no C++ compiler."""
    global _lib, build_seconds
    from ..native import build as _build

    with _lock:
        if _lib is None:
            if _build.compiler() is None:
                return None
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(_build.build()))
            lib.gs_pack.argtypes = [
                ctypes.c_void_p,  # records (N, 62) f32
                ctypes.c_int64,   # n
                ctypes.c_void_p,  # pos (3, N) f32
                ctypes.c_void_p,  # color0 (N,) u32
                ctypes.c_int,     # sh_mode
                ctypes.c_void_p,  # sh_out (45, N)
                ctypes.c_void_p,  # sh_mn (N,)
                ctypes.c_void_p,  # sh_span (N,)
                ctypes.c_int,     # cov_mode
                ctypes.c_void_p,  # cov_out (6, N)
                ctypes.c_int,     # n_threads (0: one per hardware thread)
            ]
            lib.gs_pack.restype = None
            _lib = lib
            build_seconds = time.perf_counter() - t0
    return _lib


def available() -> bool:
    """True where the codec builds (at first use) and loads."""
    return _load() is not None


def pack_gaussians_native(g: Gaussians, comp: Compressions, n_threads: int = 0) -> dict | None:
    """Fused native pack -> the flat raw pod (pos (3, N) f32, color0 (N,)
    u32, sh (45, N) f32 | f16 | u8 with sh_mn, sh_span (N,) f32 for norm8,
    cov3d (6, N) f32 | f16); None where the machine has no C++ compiler."""
    lib = _load()
    if lib is None:
        return None
    n = g.count
    records = np.ascontiguousarray(g.to_pod_records()).view("<f4").reshape(n, 62)
    out = {"pos": np.empty((3, n), np.float32), "color0": np.empty(n, np.uint32)}
    if comp.sh in _SH_DTYPE:
        out["sh"] = np.empty((45, n), _SH_DTYPE[comp.sh])
    if comp.sh == ShCompression.NORM8:
        out["sh_mn"] = np.empty(n, np.float32)
        out["sh_span"] = np.empty(n, np.float32)
    cov_mode = _COV_MODE[comp.cov3d]
    out["cov3d"] = np.empty((6, n), np.float32 if cov_mode == 0 else np.float16)

    def ptr(name):
        a = out.get(name)
        return None if a is None else a.ctypes.data_as(ctypes.c_void_p)

    lib.gs_pack(records.ctypes.data_as(ctypes.c_void_p), n, ptr("pos"), ptr("color0"),
                _SH_MODE[comp.sh], ptr("sh"), ptr("sh_mn"), ptr("sh_span"),
                cov_mode, ptr("cov3d"), int(n_threads))
    return out
