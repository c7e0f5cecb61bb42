"""Fused splat front-end: word pod -> unsorted packed entries.

`enumerate_entries_fused` is the counterpart of
`wgpu_3dgs_viewer_app_tpu.ops.fused.enumerate_entries_fused`. On a CUDA pod
it launches kernel K1 (`csrc/fused.cu`): one pass over the pod doing what
`preprocess` + `enumerate_entries_from_pre` do. On a CPU pod it runs that
plain version, `enumerate_entries_plain`. Either way the result is
(N * max_dup, 4) int32 entries, slot d of splat s at row s * max_dup + d.
"""

from __future__ import annotations

import ctypes

import torch

from ..data.compression import Compressions, Cov3dCompression, ShCompression
from . import kernels
from .binning import SortedEntries, TileConfig, enumerate_entries_from_pre
from .preprocess import check_ungated, frame_scalars, preprocess
from .sort import sort_entries

_SH_CODE = {ShCompression.SINGLE: 0, ShCompression.HALF: 1, ShCompression.NORM8: 2,
            ShCompression.REMOVE: 3}
_SH_ROWS = {ShCompression.SINGLE: (45, torch.float32), ShCompression.HALF: (23, torch.int32),
            ShCompression.NORM8: (12, torch.int32)}


def _frame_param_array(fs: dict, cfg: TileConfig) -> list:
    """The 44 f32 frame scalars in `csrc/fused.cu::FrameParams` order."""
    flat = lambda rows: [v for row in rows for v in row]  # noqa: E731
    vals = (flat(fs["m3"]) + list(fs["mt"]) + flat(fs["v3"]) + list(fs["vt"])
            + [fs[k] for k in ("p00", "p11", "fx", "fy", "tanx", "tany", "limx", "limy",
                               "width", "height", "size2", "r_pt", "inv_pt")]
            + list(fs["cam"])
            + [fs["z_near"], fs["z_far"], cfg.depth_scale, float(2 ** cfg.v2_depth_bits - 1)])
    assert len(vals) == 44, len(vals)
    return vals


def enumerate_entries_plain(pod: dict, comp: Compressions, cfg: TileConfig, view, proj, model,
                            sh_degree: int = 3, no_sh0: bool = False, size: float = 1.0,
                            display_mode: int = 0) -> torch.Tensor:
    """Plain version of K1: preprocess, then enumerate and pack."""
    pre = preprocess(pod, comp, view, proj, model, cfg.width, cfg.height, sh_degree=sh_degree,
                     no_sh0=no_sh0, size=size, display_mode=display_mode)
    return enumerate_entries_from_pre(pre, cfg)


def _enumerate_entries_cuda(pod, comp, cfg, view, proj, model, sh_degree, no_sh0, size,
                            display_mode) -> torch.Tensor:
    lib = kernels.library()
    n = pod["color0"].shape[-1]
    kernels.require(pod["pos"], "pos", torch.float32, (3, n))
    kernels.require(pod["color0"], "color0", torch.int32, (n,))
    if comp.cov3d == Cov3dCompression.SINGLE:
        kernels.require(pod["cov3d"], "cov3d", torch.float32, (6, n))
    else:
        kernels.require(pod["cov3d"], "cov3d", torch.int32, (3, n))
    sh = mn = span = None
    if comp.sh != ShCompression.REMOVE:
        rows, dtype = _SH_ROWS[comp.sh]
        sh = pod["sh"]
        kernels.require(sh, "sh", dtype, (rows, n))
    if comp.sh == ShCompression.NORM8:
        mn, span = pod["sh_mn"], pod["sh_span"]
        kernels.require(mn, "sh_mn", torch.float32, (n,))
        kernels.require(span, "sh_span", torch.float32, (n,))
    if not 0 <= sh_degree <= 3 or display_mode not in (0, 1, 2):
        raise ValueError(f"sh_degree {sh_degree} / display_mode {display_mode} out of range")
    fs = frame_scalars(view, proj, model, cfg.width, cfg.height, size)
    frame = (ctypes.c_float * 44)(*_frame_param_array(fs, cfg))
    iparams = (ctypes.c_int * 11)(
        n, _SH_CODE[comp.sh], int(comp.cov3d == Cov3dCompression.HALF), sh_degree, int(no_sh0),
        display_mode, cfg.tile, cfg.tiles_x, cfg.tiles_y, cfg.max_dup, cfg._tile_shift)
    out = torch.empty((n * cfg.max_dup, 4), dtype=torch.int32, device=pod["color0"].device)
    p = kernels.ptr
    kernels.check(lib.gs_fused_frontend(frame, iparams, p(pod["pos"]), p(pod["color0"]),
                                        p(pod["cov3d"]), p(sh), p(mn), p(span), p(out),
                                        kernels.stream()), "gs_fused_frontend")
    kernels.LAUNCHES["fused"] += 1
    return out


def enumerate_entries_fused(
    pod: dict,
    comp: Compressions,
    cfg: TileConfig,
    view,
    proj,
    model,
    sh_degree: int = 3,
    no_sh0: bool = False,
    size: float = 1.0,
    display_mode: int = 0,
    mask_bits=None,
    edit=None,
    selection_bits=None,
    selection_edit=None,
    highlight_rgba=None,
) -> torch.Tensor:
    """pod -> (N * max_dup, 4) int32 entries: kernel K1 on a CUDA pod, the
    plain version on a CPU pod. `view`, `proj`, `model`: (4, 4) f32 host
    matrices."""
    check_ungated(mask_bits=mask_bits, edit=edit, selection_bits=selection_bits,
                  selection_edit=selection_edit, highlight_rgba=highlight_rgba)
    args = (pod, comp, cfg, view, proj, model, sh_degree, no_sh0, size, display_mode)
    if pod["color0"].device.type == "cpu":
        return enumerate_entries_plain(*args)
    return _enumerate_entries_cuda(*args)


def build_sorted_entries_fused(
    pod: dict,
    comp: Compressions,
    cfg: TileConfig,
    view,
    proj,
    model,
    sh_degree: int = 3,
    no_sh0: bool = False,
    size: float = 1.0,
    display_mode: int = 0,
    **gates,
) -> SortedEntries:
    """pod -> SortedEntries: the front-end (K1) then the entry sort (K2)."""
    entries = enumerate_entries_fused(pod, comp, cfg, view, proj, model, sh_degree, no_sh0,
                                      size, display_mode, **gates)
    return sort_entries(entries, cfg)
