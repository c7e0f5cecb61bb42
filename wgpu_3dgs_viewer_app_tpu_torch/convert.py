"""Carry the JAX package's arrays into the port and back (numpy in, numpy
out, so this module needs no JAX).

- `pod_from_jax`: a JAX pod, rows layout (k, R, 128) or flat words (k, N),
  -> the port's flat word tensors;
- `sorted_entries_from_jax` / `sorted_entries_to_jax`: the JAX
  `SortedEntries` fields (planes (R, 4, 128) u32, tile starts/counts,
  n_valid) <-> the port's `SortedEntries` ((E, 4) int32 entries).
"""

from __future__ import annotations

import numpy as np
import torch

from .data.compression import Compressions, ShCompression, pod_to_tensors
from .ops.binning import ROW, SortedEntries


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
        words[k] = v
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
    ent = se.entries.cpu().numpy().view(np.uint32)
    ent = np.concatenate([ent, np.zeros(((-len(ent)) % ROW, 4), np.uint32)])
    planes = np.ascontiguousarray(ent.reshape(-1, ROW, 4).transpose(0, 2, 1))
    return (planes, se.tile_starts.cpu().numpy().astype(np.int32),
            se.tile_counts.cpu().numpy().astype(np.int32), np.int32(se.n_valid))
