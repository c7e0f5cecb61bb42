"""Fused splat front-end and query-geometry pass over the word pod.

- `enumerate_entries_fused` is the counterpart of
  `wgpu_3dgs_viewer_app_tpu.ops.fused.enumerate_entries_fused`. On a CUDA pod
  it launches kernel K1 (`csrc/fused.cu`): one pass over the pod doing what
  `preprocess` + `enumerate_entries_from_pre` do, gates and model rank
  included. On a CPU pod it runs that plain version,
  `enumerate_entries_plain`. Either way the result is (N * max_dup, 4) int32
  entries, slot d of splat s at row s * max_dup + d.
- `preprocess_geometry_fused` is the counterpart of the JAX function of the
  same name: the degree-0 preprocess the selection and hit queries read. On
  a CUDA pod it launches kernel K4 (`csrc/geometry.cu`); on a CPU pod it
  runs its plain version, `preprocess_geometry_plain`.
- `preprocess_fused` is the staged front-end's preprocess (SH 0-3, every
  gate) as one kernel, K8 (`csrc/geometry.cu`, the same template as K4), on
  a CUDA pod; on a CPU pod it runs the plain `preprocess`. The reference
  runs that function as one XLA program (`jax.jit`); the plain version in
  eager torch would be ~1,100-3,400 launches on the card.

The kernels read the gate tensors where they lie: `mask_bits` and
`selection_bits` as (N,) uint8, the per-splat edit as int32 flags (N,),
f32 rgb (N, 3) and f32 params (N, 4). The scene-wide selection edit and
highlight ride the frame scalars. K4 and K8 take them by value; K1 takes
them from a FrameRecord in device memory, which its launcher copies into
the kernel's constant record on the stream before the launch, so that a
launch captured in a CUDA graph takes each frame's values.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..data.compression import Compressions, Cov3dCompression, ShCompression
from . import kernels
from .binning import (SortedEntries, TileConfig, check_model_rank,
                      enumerate_entries_from_pre_plain)
from .preprocess import (PreprocessOut, frame_scalars, highlight_scalars, preprocess,
                         selection_edit_scalars)
from .sort import sort_entries

_SH_CODE = {ShCompression.SINGLE: 0, ShCompression.HALF: 1, ShCompression.NORM8: 2,
            ShCompression.REMOVE: 3}
_SH_ROWS = {ShCompression.SINGLE: (45, torch.float32), ShCompression.HALF: (23, torch.int32),
            ShCompression.NORM8: (12, torch.int32)}
# Gate bits of `csrc/splat.cuh::IntParams::gates`.
GATE_MASK, GATE_EDIT, GATE_SEL_EDIT, GATE_HIGHLIGHT = 1, 2, 4, 8
_FRAME_FLOATS, _INT_PARAMS = 55, 15
# `csrc/splat.cuh::FrameRecord`: the frame floats, then the selection edit's
# flags and the model rank, in 64 words.
RECORD_WORDS = 64
_REC_SEL_FLAGS, _REC_RANK = _FRAME_FLOATS, _FRAME_FLOATS + 1
_EYE = np.eye(4, dtype=np.float32)


def _frame_param_array(fs: dict, cfg, scene_consts=(0.0,) * 11) -> list:
    """The 55 f32 frame scalars in `csrc/splat.cuh::FrameParams` order;
    `scene_consts`: selection-edit rgb (3) and params (4), highlight (4)."""
    flat = lambda rows: [v for row in rows for v in row]  # noqa: E731
    depth = [cfg.depth_scale, float(2 ** cfg.v2_depth_bits - 1)] if cfg is not None else [0.0, 0.0]
    vals = (flat(fs["m3"]) + list(fs["mt"]) + flat(fs["v3"]) + list(fs["vt"])
            + [fs[k] for k in ("p00", "p11", "fx", "fy", "tanx", "tany", "limx", "limy",
                               "width", "height", "size2", "r_pt", "inv_pt")]
            + list(fs["cam"]) + [fs["z_near"], fs["z_far"]] + depth + list(scene_consts))
    assert len(vals) == _FRAME_FLOATS, len(vals)
    return vals


def _int_param_array(n: int, comp: Compressions, display_mode: int, gate_code: int,
                     sh_degree: int = 0, no_sh0: bool = False, cfg=None, sel_flags: int = 0,
                     model_rank: int = 0):
    """The 15 int scalars in `csrc/splat.cuh::IntParams` order; the tiling
    and key layout (K1 only) from `cfg`."""
    tiling = ([cfg.tile, cfg.tiles_x, cfg.tiles_y, cfg.max_dup, cfg._tile_shift]
              if cfg is not None else [0] * 5)
    rank = [cfg._rank_shift, check_model_rank(cfg, model_rank)] if cfg is not None else [0, 0]
    vals = ([n, _SH_CODE[comp.sh], int(comp.cov3d == Cov3dCompression.HALF), sh_degree,
             int(no_sh0), display_mode] + tiling + [gate_code, sel_flags] + rank)
    assert len(vals) == _INT_PARAMS, len(vals)
    return (ctypes.c_int * _INT_PARAMS)(*vals)


def frame_base(view, proj, cfg, size: float) -> np.ndarray:
    """The (55,) f32 frame floats that every model of a frame shares:
    `_frame_param_array` at an identity model and no scene constants."""
    fs = frame_scalars(view, proj, _EYE, cfg.width, cfg.height, size)
    return np.asarray(_frame_param_array(fs, cfg), np.float32)


def write_frame_record(row: np.ndarray, base: np.ndarray, model, model_rank: int, cfg,
                       scene_consts=(0.0,) * 11, sel_flags: int = 0) -> np.ndarray:
    """Write one model's FrameRecord into `row`, (RECORD_WORDS,) int32: the
    frame floats of `frame_base` with the model's matrix rows and the scene
    constants put in (so `_frame_param_array` of the model's frame scalars
    to the bit), the selection edit's flags (int32) and the model's rank.
    The words past those are left as they are."""
    model = np.asarray(model, np.float32)
    f = row.view(np.float32)
    f[:_FRAME_FLOATS] = base
    f[0:9] = model[:3, :3].reshape(9)
    f[9:12] = model[:3, 3]
    f[_FRAME_FLOATS - 11:_FRAME_FLOATS] = scene_consts
    row[_REC_SEL_FLAGS] = sel_flags
    row[_REC_RANK] = check_model_rank(cfg, model_rank)
    return row


def _i32(v: int) -> int:
    """A u32 value as the int32 with the same bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


def _cuda_gates(n: int, device, mask_bits=None, edit=None, selection_bits=None,
                selection_edit=None, highlight_rgba=None, check: bool = True) -> tuple:
    """Check the gate tensors a kernel reads (unless `check` is False) and
    return (gate bits, selection-edit flags as int32, the 11 scene
    constants, [mask, sel, flags, rgb, params] tensors or None)."""
    req = kernels.require if check else (lambda *a: None)
    code, sel_flags, consts = 0, 0, [0.0] * 11
    tensors = [None] * 5
    if mask_bits is not None:
        req(mask_bits, "mask_bits", torch.uint8, (n,), device)
        code |= GATE_MASK
        tensors[0] = mask_bits
    if edit is not None:
        flags, rgb, params = edit
        req(flags, "edit flags", torch.int32, (n,), device)
        req(rgb, "edit rgb", torch.float32, (n, 3), device)
        req(params, "edit params", torch.float32, (n, 4), device)
        code |= GATE_EDIT
        tensors[2:] = [flags, rgb, params]
    if selection_bits is not None and (selection_edit is not None or highlight_rgba is not None):
        req(selection_bits, "selection_bits", torch.uint8, (n,), device)
        tensors[1] = selection_bits
        if selection_edit is not None:
            sel_flags, rgb, params = selection_edit_scalars(selection_edit)
            consts[:7] = rgb + params
            code |= GATE_SEL_EDIT
        if highlight_rgba is not None:
            consts[7:] = highlight_scalars(highlight_rgba)
            code |= GATE_HIGHLIGHT
    return code, _i32(sel_flags), consts, tensors


def _require_pod(pod: dict, comp: Compressions, n: int, sh: bool) -> None:
    dev = pod["color0"].device
    kernels.require(pod["pos"], "pos", torch.float32, (3, n), dev)
    kernels.require(pod["color0"], "color0", torch.int32, (n,), dev)
    if comp.cov3d == Cov3dCompression.SINGLE:
        kernels.require(pod["cov3d"], "cov3d", torch.float32, (6, n), dev)
    else:
        kernels.require(pod["cov3d"], "cov3d", torch.int32, (3, n), dev)
    if sh and comp.sh != ShCompression.REMOVE:
        rows, dtype = _SH_ROWS[comp.sh]
        kernels.require(pod["sh"], "sh", dtype, (rows, n), dev)
    if sh and comp.sh == ShCompression.NORM8:
        kernels.require(pod["sh_mn"], "sh_mn", torch.float32, (n,), dev)
        kernels.require(pod["sh_span"], "sh_span", torch.float32, (n,), dev)


def enumerate_entries_plain(pod: dict, comp: Compressions, cfg: TileConfig, view, proj, model,
                            sh_degree: int = 3, no_sh0: bool = False, size: float = 1.0,
                            display_mode: int = 0, model_rank: int = 0, **gates) -> torch.Tensor:
    """Plain version of K1: preprocess (gates included), then enumerate and
    pack (plain too, whatever the device)."""
    pre = preprocess(pod, comp, view, proj, model, cfg.width, cfg.height, sh_degree=sh_degree,
                     no_sh0=no_sh0, size=size, display_mode=display_mode, **gates)
    return enumerate_entries_from_pre_plain(pre, cfg, model_rank)


def _sh_tensors(pod: dict, comp: Compressions) -> tuple:
    """The pod's SH words and its norm8 range (None where the compression
    has none), as K1 and K8 read them."""
    sh = pod.get("sh") if comp.sh != ShCompression.REMOVE else None
    if comp.sh == ShCompression.NORM8:
        return sh, pod["sh_mn"], pod["sh_span"]
    return sh, None, None


def _enumerate_entries_cuda(pod, comp, cfg, view, proj, model, sh_degree, no_sh0, size,
                            display_mode, model_rank, gates: dict, out=None,
                            record=None) -> torch.Tensor:
    lib = kernels.library()
    n = pod["color0"].shape[-1]
    dev = pod["color0"].device
    _require_pod(pod, comp, n, sh=True)
    if not 0 <= sh_degree <= 3 or display_mode not in (0, 1, 2):
        raise ValueError(f"sh_degree {sh_degree} / display_mode {display_mode} out of range")
    code, sel_flags, consts, gt = _cuda_gates(n, dev, **gates)
    iparams = _int_param_array(n, comp, display_mode, code, sh_degree, no_sh0, cfg, sel_flags,
                               model_rank)
    if record is None:
        # The kernel reads its frame record from the device: here one of its
        # own, copied from pinned memory (no wait).
        host = torch.zeros(RECORD_WORDS, dtype=torch.int32, pin_memory=True)
        write_frame_record(host.numpy(), frame_base(view, proj, cfg, size), model, model_rank,
                           cfg, consts, sel_flags)
        record = host.to(dev, non_blocking=True)
    else:
        kernels.require(record, "record", torch.int32, (RECORD_WORDS,), dev)
    if out is None:
        out = torch.empty((n * cfg.max_dup, 4), dtype=torch.int32, device=dev)
    else:
        kernels.require(out, "out", torch.int32, (n * cfg.max_dup, 4), dev)
    p = kernels.ptr
    sh, mn, span = _sh_tensors(pod, comp)
    kernels.check(lib.gs_fused_frontend(p(record), iparams, p(pod["pos"]), p(pod["color0"]),
                                        p(pod["cov3d"]), p(sh), p(mn), p(span),
                                        *(p(t) for t in gt), p(out), kernels.stream()),
                  "gs_fused_frontend")
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
    model_rank: int = 0,
    mask_bits=None,
    edit=None,
    selection_bits=None,
    selection_edit=None,
    highlight_rgba=None,
    out=None,
    record=None,
) -> torch.Tensor:
    """pod -> (N * max_dup, 4) int32 entries: kernel K1 on a CUDA pod, the
    plain version on a CPU pod. `view`, `proj`, `model`: (4, 4) f32 host
    matrices. `model_rank` keys the merged multi-model frame (needs
    `cfg.model_bits` > 0; nearest model = 0). Gates as in `preprocess`; only
    the given ones cost anything. `out`: an (N * max_dup, 4) int32 tensor (or
    a row slice of a larger one) to write into. `record` (card only): the
    model's FrameRecord on the device (`write_frame_record`), which K1 then reads
    for the frame's scalars, the selection edit's flags and the rank in
    place of those arguments."""
    gates = dict(mask_bits=mask_bits, edit=edit, selection_bits=selection_bits,
                 selection_edit=selection_edit, highlight_rgba=highlight_rgba)
    args = (pod, comp, cfg, view, proj, model, sh_degree, no_sh0, size, display_mode,
            model_rank)
    if pod["color0"].device.type == "cpu":
        ent = enumerate_entries_plain(*args, **gates)
        return ent if out is None else out.copy_(ent)
    return _enumerate_entries_cuda(*args, gates, out, record)


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
    model_rank: int = 0,
    **gates,
) -> SortedEntries:
    """pod -> SortedEntries: the front-end (K1) then the entry sort (K2)."""
    entries = enumerate_entries_fused(pod, comp, cfg, view, proj, model, sh_degree, no_sh0,
                                      size, display_mode, model_rank, **gates)
    return sort_entries(entries, cfg)


def preprocess_geometry_plain(pod: dict, comp: Compressions, view, proj, model, width: int,
                              height: int, size: float = 1.0, display_mode: int = 0,
                              mask_bits=None, edit=None) -> PreprocessOut:
    """Plain version of K4: the preprocess at SH degree 0."""
    return preprocess(pod, comp, view, proj, model, width, height, sh_degree=0, size=size,
                      display_mode=display_mode, mask_bits=mask_bits, edit=edit)


def _planes_cuda(entry: str, counter: str, pod, comp, view, proj, model, width, height,
                 sh_degree, no_sh0, size, display_mode, gates: dict) -> PreprocessOut:
    """Launch K4 (`gs_geometry`: no SH read, mask and edit gates) or K8
    (`gs_preprocess`) into the 11 f32 planes and `valid` of a
    PreprocessOut."""
    lib = kernels.library()
    n = pod["color0"].shape[-1]
    dev = pod["color0"].device
    with_sh = entry == "gs_preprocess"
    _require_pod(pod, comp, n, sh=with_sh)
    if not 0 <= sh_degree <= 3 or display_mode not in (0, 1, 2):
        raise ValueError(f"sh_degree {sh_degree} / display_mode {display_mode} out of range")
    code, sel_flags, consts, gt = _cuda_gates(n, dev, **gates)
    fs = frame_scalars(view, proj, model, width, height, size)
    frame = (ctypes.c_float * _FRAME_FLOATS)(*_frame_param_array(fs, None, consts))
    iparams = _int_param_array(n, comp, display_mode, code, sh_degree, no_sh0,
                               sel_flags=sel_flags)
    planes = torch.empty((11, n), dtype=torch.float32, device=dev)
    valid = torch.empty(n, dtype=torch.bool, device=dev)
    p = kernels.ptr
    sh = _sh_tensors(pod, comp) if with_sh else (None, None, None)
    kernels.check(getattr(lib, entry)(frame, iparams, p(pod["pos"]), p(pod["color0"]),
                                      p(pod["cov3d"]), *(p(t) for t in sh), *(p(t) for t in gt),
                                      p(planes), p(valid), kernels.stream()), entry)
    kernels.LAUNCHES[counter] += 1
    return PreprocessOut(*planes.unbind(0), valid=valid)


def preprocess_geometry_fused(pod: dict, comp: Compressions, view, proj, model, width: int,
                              height: int, size: float = 1.0, display_mode: int = 0,
                              mask_bits=None, edit=None) -> PreprocessOut:
    """Degree-0 per-splat geometry for the queries -> PreprocessOut: kernel
    K4 on a CUDA pod, the plain version on a CPU pod. Gates: `mask_bits` and
    the per-splat `edit`, as in `preprocess`."""
    if pod["color0"].device.type == "cpu":
        return preprocess_geometry_plain(pod, comp, view, proj, model, width, height, size,
                                         display_mode, mask_bits, edit)
    return _planes_cuda("gs_geometry", "geometry", pod, comp, view, proj, model, width, height,
                        0, False, size, display_mode, dict(mask_bits=mask_bits, edit=edit))


def preprocess_fused(
    pod: dict,
    comp: Compressions,
    view,
    proj,
    model,
    width: int,
    height: int,
    sh_degree: int = 3,
    no_sh0: bool = False,
    size: float = 1.0,
    display_mode: int = 0,
    mask_bits=None,
    edit=None,
    selection_bits=None,
    selection_edit=None,
    highlight_rgba=None,
) -> PreprocessOut:
    """The per-splat preprocess -> PreprocessOut: kernel K8 on a CUDA pod,
    the plain `preprocess` on a CPU pod. Arguments and gates as in
    `preprocess`; only the given gates cost anything. The fields are rows
    of one (11, N) f32 tensor on the card."""
    gates = dict(mask_bits=mask_bits, edit=edit, selection_bits=selection_bits,
                 selection_edit=selection_edit, highlight_rgba=highlight_rgba)
    if pod["color0"].device.type == "cpu":
        return preprocess(pod, comp, view, proj, model, width, height, sh_degree=sh_degree,
                          no_sh0=no_sh0, size=size, display_mode=display_mode, **gates)
    return _planes_cuda("gs_preprocess", "preprocess", pod, comp, view, proj, model, width,
                        height, sh_degree, no_sh0, size, display_mode, gates)
