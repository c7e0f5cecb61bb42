"""Carry the JAX package's arrays into the port and back (numpy in, numpy
out, so this module needs no JAX).

- `pod_from_jax`: a JAX pod, rows layout (k, R, 128) or flat words (k, N),
  -> the port's flat word tensors;
- `sorted_entries_from_jax` / `sorted_entries_to_jax`: the JAX
  `SortedEntries` fields (planes (R, 4, 128) u32, tile starts/counts,
  n_valid) <-> the port's `SortedEntries` ((E, 4) int32 entries);
- `edits_from_jax` / `bits_from_jax`: the JAX buffers' per-splat state (the
  edit SoA, the selection and mask bits, all padded to a multiple of 128)
  -> the port's buffer tensors at the port's capacity;
- `viewer_from_scene`: a whole multi-model scene of the JAX viewer, given
  as plain data (pods, transforms, visibility, centres, editing state), ->
  a port `MultiModelViewer` with the same state;
- `preprocess_out_from_jax`, `tile_lists_from_jax`, `entry_planes_from_jax`:
  the v1 chain's intermediate state (the JAX `PreprocessOut`, `TileLists`
  and `EntryPlanes` fields) -> the port's containers, so that both chains
  can be fed the same input at any stage;
- `mask_shape_from_jax`, `mask_pod_from_jax`, `mask_op_from_jax`: the JAX
  mask shapes, their pods (numpy f32 on both sides) and op trees -> the
  port's, read by attribute;
- `measurement_from_jax`: a JAX `Measurement` (its hit pairs and hit
  method) -> the port's.
"""

from __future__ import annotations

import numpy as np
import torch

from .app.measurement import Measurement, MeasurementHit, MeasurementHitPair
from .core.transform import ModelTransform
from .data.compression import Compressions, ShCompression, pod_to_tensors
from .mask.expr import MaskOp
from .mask.shapes import MaskOpShapePod, MaskShape, MaskShapeKind
from .ops.binning import N_PLANES, ROW, EntryPlanes, SortedEntries, TileLists
from .ops.preprocess import PreprocessOut
from .query.hit import MeasurementHitMethod
from .viewer.viewer import MultiModelViewer, ViewerModel


def pod_from_jax(pod_np: dict, comp: Compressions, device="cpu", n: int | None = None) -> dict:
    """JAX pod (numpy arrays) -> port word pod on `device`. A rows-layout pod
    (color0 of shape (R, 128)) is flattened to its padded capacity R * 128,
    or cut to the first `n` splats when `n` is given."""
    rows = np.asarray(pod_np["color0"]).ndim == 2
    words = {}
    for k, v in pod_np.items():
        v = np.asarray(v)
        if rows:
            v = v.reshape(v.shape[:-2] + (-1,))
        if n is not None:
            v = v[..., :n]
        words[k] = np.array(v)  # a writable copy: device arrays read back read-only
    expected = {"pos", "color0", "cov3d"}
    if comp.sh != ShCompression.REMOVE:
        expected.add("sh")
    if comp.sh == ShCompression.NORM8:
        expected |= {"sh_mn", "sh_span"}
    if set(words) != expected:
        raise ValueError(f"pod fields {sorted(words)} do not match {comp}")
    return pod_to_tensors(words, device)


def sorted_entries_from_jax(planes, tile_starts, tile_counts, n_valid, device="cpu") -> SortedEntries:
    """JAX SortedEntries fields (numpy) -> port SortedEntries."""
    planes = np.asarray(planes, np.uint32)  # (R, 4, 128)
    ent = np.ascontiguousarray(planes.transpose(0, 2, 1).reshape(-1, 4)).view(np.int32)
    return SortedEntries(
        entries=torch.from_numpy(ent).to(device),
        tile_starts=torch.from_numpy(np.asarray(tile_starts, np.int32)).to(device),
        tile_counts=torch.from_numpy(np.asarray(tile_counts, np.int32)).to(device),
        n_valid=int(n_valid),
    )


def sorted_entries_to_jax(se: SortedEntries) -> tuple:
    """Port SortedEntries -> (planes (R, 4, 128) u32, tile_starts, tile_counts,
    n_valid) numpy, the fields of the JAX SortedEntries. Entries pad with
    zeros to a multiple of 128 (never inside any tile range)."""
    ent = se.live().cpu().numpy().view(np.uint32)
    ent = np.concatenate([ent, np.zeros(((-len(ent)) % ROW, 4), np.uint32)])
    planes = np.ascontiguousarray(ent.reshape(-1, ROW, 4).transpose(0, 2, 1))
    return (planes, se.tile_starts.cpu().numpy().astype(np.int32),
            se.tile_counts.cpu().numpy().astype(np.int32), np.int32(se.n_valid))


def preprocess_out_from_jax(fields: dict, device="cpu") -> PreprocessOut:
    """JAX PreprocessOut fields (field name -> numpy (N,) array; f32, and
    bool `valid`) -> port PreprocessOut, bit for bit."""
    out = {}
    for name in PreprocessOut.__dataclass_fields__:
        dtype = np.bool_ if name == "valid" else np.float32
        out[name] = torch.from_numpy(np.array(fields[name], dtype=dtype)).to(device)
    return PreprocessOut(**out)


def tile_lists_from_jax(sorted_idx, sorted_keys, tile_starts, tile_counts, n_valid,
                        device="cpu") -> TileLists:
    """JAX TileLists fields (numpy; N * D long with a sentinel tail) -> port
    TileLists (the live prefix; keys as int32 bit patterns)."""
    n = int(n_valid)
    keys = np.array(np.asarray(sorted_keys, np.uint32)[:n]).view(np.int32)  # writable copy
    idx = np.array(np.asarray(sorted_idx)[:n], np.int32)
    return TileLists(
        sorted_keys=torch.from_numpy(keys).to(device),
        sorted_idx=torch.from_numpy(idx).to(device),
        tile_starts=torch.from_numpy(np.array(tile_starts, np.int32)).to(device),
        tile_counts=torch.from_numpy(np.array(tile_counts, np.int32)).to(device),
        n_valid=n,
    )


def entry_planes_from_jax(ent, row_starts, tile_counts, device="cpu") -> EntryPlanes:
    """JAX EntryPlanes fields (numpy: ent (9, R, 128) f32, row starts, tile
    counts) -> port EntryPlanes, bit for bit."""
    ent = np.array(ent, np.float32)
    if ent.ndim != 3 or ent.shape[0] != N_PLANES or ent.shape[2] != ROW:
        raise ValueError(f"ent: expected ({N_PLANES}, R, {ROW}), got {ent.shape}")
    return EntryPlanes(
        ent=torch.from_numpy(ent).to(device),
        row_starts=torch.from_numpy(np.array(row_starts, np.int32)).to(device),
        tile_counts=torch.from_numpy(np.array(tile_counts, np.int32)).to(device),
    )


def _cut(a: np.ndarray, capacity: int, name: str) -> np.ndarray:
    """The first `capacity` rows of a padded JAX sidecar array."""
    if a.shape[0] < capacity:
        raise ValueError(f"{name}: {a.shape[0]} rows, fewer than capacity {capacity}")
    return np.array(a[:capacity])  # a writable copy: device arrays read back read-only


def edits_from_jax(flags, rgb, params, capacity: int, device="cpu") -> tuple:
    """JAX edit SoA (u32 flags (N_pad,), f32 rgb (N_pad, 3), f32 params
    (N_pad, 4)) -> the port's (int32 flags, rgb, params) at `capacity`."""
    flags = _cut(np.asarray(flags, np.uint32), capacity, "edit flags").view(np.int32)
    rgb = _cut(np.asarray(rgb, np.float32), capacity, "edit rgb")
    params = _cut(np.asarray(params, np.float32), capacity, "edit params")
    return tuple(torch.from_numpy(a).to(device) for a in (flags, rgb, params))


def bits_from_jax(bits, capacity: int, device="cpu") -> torch.Tensor:
    """JAX selection or mask bits (N_pad,) -> the port's (capacity,) uint8."""
    return torch.from_numpy(_cut(np.asarray(bits).astype(np.uint8), capacity, "bits")).to(device)


def viewer_from_scene(models: list, width: int, height: int, comp: Compressions,
                      device="cuda", **viewer_kw) -> MultiModelViewer:
    """A port viewer holding a JAX viewer's scene. `models`: one dict per
    model, in the JAX viewer's insertion order, with
      name, pod (the JAX rows or flat pod as numpy arrays), count (loaded
      splats), pos / rot / scale (the `ModelTransform` fields), visible,
      center, and optionally edits (flags, rgb, params), selection, mask
      (the JAX buffers' padded arrays).
    The pod words are taken as they are (no re-pack), so both viewers render
    the same compressed splats. `viewer_kw` goes to `MultiModelViewer`
    (tile, max_dup, background, fused)."""
    v = MultiModelViewer(width, height, comp=comp, device=device, **viewer_kw)
    for spec in models:
        n = int(spec["count"])
        m = ViewerModel(v.dedup_key(spec["name"]), n, comp, v.device)
        b = m.buffers
        pod = pod_from_jax(spec["pod"], comp, v.device, n=b.capacity)
        for k, t in pod.items():
            b.pod[k].copy_(t)
        b.loaded = n
        m.transform = ModelTransform(*(np.asarray(spec[f], np.float32)
                                       for f in ("pos", "rot", "scale")))
        m.visible = bool(spec.get("visible", True))
        m.center = np.asarray(spec["center"], np.float32)
        if spec.get("edits") is not None:
            b.set_edits(*edits_from_jax(*spec["edits"], b.capacity, v.device))
        if spec.get("selection") is not None:
            b.set_selection(bits_from_jax(spec["selection"], b.capacity, v.device))
        if spec.get("mask") is not None:
            b.set_mask(bits_from_jax(spec["mask"], b.capacity, v.device))
        v.models[m.file_name] = m
    return v


def mask_shape_from_jax(shape) -> MaskShape:
    """JAX `MaskShape` -> port `MaskShape` (same kind, TRS, colour, visibility)."""
    return MaskShape(kind=MaskShapeKind(shape.kind.value),
                     pos=np.array(shape.pos, np.float32), rot=np.array(shape.rot, np.float32),
                     scale=np.array(shape.scale, np.float32),
                     color=np.array(shape.color, np.float32), visible=bool(shape.visible))


def mask_pod_from_jax(pod) -> MaskOpShapePod:
    """JAX `MaskOpShapePod` -> port pod (numpy f32 on both sides)."""
    return MaskOpShapePod(kind=MaskShapeKind(pod.kind.value),
                          inv_lin=np.array(pod.inv_lin, np.float32),
                          pos=np.array(pod.pos, np.float32))


def mask_op_from_jax(op):
    """JAX `MaskOp` tree (or None, Reset) -> port `MaskOp` tree."""
    if op is None:
        return None
    return MaskOp(op.kind, left=mask_op_from_jax(op.left), right=mask_op_from_jax(op.right),
                  index=op.index)


def measurement_from_jax(m) -> Measurement:
    """JAX `Measurement` -> port `Measurement`: the hit pairs (label,
    visibility, colour, width, both positions) and the hit method."""
    pairs = [MeasurementHitPair(label=p.label, visible=bool(p.visible), color=tuple(p.color),
                                line_width=float(p.line_width),
                                hits=[MeasurementHit(np.array(h.pos, np.float32))
                                      for h in p.hits])
             for p in m.hit_pairs]
    return Measurement(hit_pairs=pairs, hit_method=MeasurementHitMethod(m.hit_method.value))
