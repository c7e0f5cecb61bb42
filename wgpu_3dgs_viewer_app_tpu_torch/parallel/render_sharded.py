"""Sharded rendering over `torch.distributed`: the slab-owner renderer.

Counterpart of `wgpu_3dgs_viewer_app_tpu.parallel.render_sharded`, with
its names and contract. The ranks call it SPMD, each on its own shard:

- **Splat axis = data parallel.** `shard_pod` gives each rank a
  contiguous run of splats. Each rank preprocesses its run
  (`preprocess_fused`: kernel K8 on CUDA), enumerates its entries in the
  GLOBAL key layout (kernel K5 on CUDA) and sorts them (K2), with no
  communication.
- **Tile axis = output parallel.** The screen is cut into one slab of
  whole tile rows per rank (`slab_config`); rank r owns slab r. A rank's
  sorted entries hold one contiguous run per slab, which starts at the run
  edge of the slab's first tile: the searchsorted of the sorted keys
  against the slab boundary keys, which K2's tile edges already are.
- **Routing.** One small `all_to_all_single` gives every rank the whole
  (world, world) send matrix and each owner's receive capacity
  (`capacity_factor` x the owner's entry slots, in 128s). The matrix is
  read to the host, the runs are clamped as the JAX step clamps them
  (later sources drop first), and a second `all_to_all_single` with exact
  split sizes sends only the live entries to their owners. The count of
  clamped entries is the frame's overflow, the same on every rank.
- **Owner.** One K2 sort of the received runs, concatenated in source-rank
  order (K2 is stable and the shards are contiguous, so equal keys keep the
  single-device order), the slab's tile edges taken from the global key
  layout, K3 over the slab, the background, and an `all_gather` of the
  equal-size slabs, so every rank returns the whole frame.

Host syncs: K2 reads its live count to the host (twice a frame here: the
local sort and the owner's), and the route reads the send matrix; nothing
else waits for the device.

Not carried from the JAX module: the equal-split transport (`ragged=False`,
there because XLA:CPU lacks a ragged all-to-all), `use_pallas` (kernels
follow the tensors' device, as everywhere in the port) and the padding of
each shard to 128-splat rows (the TPU row layout).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.transform import GaussianDisplayMode
from ..data.compression import Compressions, pod_to_tensors
# SENTINEL: the dead-slot key, under the JAX module's name (K2 drops such
# entries before routing, so none is ever sent).
from ..ops.binning import SENTINEL  # noqa: F401
from ..ops.binning import SortedEntries, TileConfig, enumerate_entries_from_pre
from ..ops.composite import composite_tiles_v2, over_background
from ..ops.fused import preprocess_fused
from ..ops.sort import sort_entries

# Routing stats of the last `render_sharded` in this process, for the app
# server's /state ("parallel"); a skewed scene whose routing overflowed
# `capacity_factor` is otherwise silent.
_LAST = {"overflow": None, "n_devices": 0}


def last_stats() -> dict | None:
    """{"overflow": int, "n_devices": int} of the most recent sharded
    render in this process, or None if none has run."""
    if _LAST["overflow"] is None:
        return None
    return {"overflow": _LAST["overflow"], "n_devices": _LAST["n_devices"]}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of one process group that render a frame together, seen
    from this rank: `device` is where this rank's tensors live."""

    group: object
    rank: int
    world: int
    device: torch.device
    axis: str = "splats"


def make_mesh(devices=None, axis: str = "splats") -> Mesh:
    """This rank's `Mesh` over a process group the caller initialised.

    `devices`: None for the default group (tensors on the current CUDA
    device under NCCL, else on the CPU), or a `DeviceMesh` from
    `torch.distributed.device_mesh.init_device_mesh` (its group along
    `axis`, or along its only dimension). Never initialises a backend."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group or init_device_mesh)")
    if devices is None:
        group = dist.group.WORLD
        device_type = "cuda" if dist.get_backend(group) == "nccl" else "cpu"
    elif isinstance(devices, DeviceMesh):
        names = devices.mesh_dim_names or ()
        group = devices.get_group(axis if axis in names else None)
        device_type = devices.device_type
    else:
        raise TypeError(f"devices: expected None or a DeviceMesh, got {type(devices).__name__}")
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device(device_type))
    return Mesh(group=group, rank=dist.get_rank(group), world=dist.get_world_size(group),
                device=device, axis=axis)


def slab_config(cfg: TileConfig, n_devices: int) -> tuple:
    """Split the screen into `n_devices` slabs of whole tile rows.

    Returns (slab_cfg, slab_height, padded_height). The slab cfg is only
    used for compositing geometry; sort keys stay in the GLOBAL cfg's
    layout end to end.
    """
    rows_total = cfg.tiles_y
    rows_per = -(-rows_total // n_devices)
    slab_h = rows_per * cfg.tile
    padded_h = slab_h * n_devices
    slab_cfg = TileConfig(cfg.width, slab_h, tile=cfg.tile, max_dup=cfg.max_dup)
    return slab_cfg, slab_h, padded_h


def shard_bounds(n: int, world: int, rank: int) -> tuple:
    """[lo, hi) of `rank`'s contiguous run of n splats; the first n % world
    ranks take one more."""
    q, rem = divmod(n, world)
    lo = rank * q + min(rank, rem)
    return lo, lo + q + (rank < rem)


def shard_pod(pod: dict, mesh: Mesh, axis: str = "splats") -> dict:
    """This rank's contiguous run of splats of a word pod (numpy, splat axis
    last: `flat_pod_to_words`), as tensors on the mesh's device."""
    _check_axis(mesh, axis)
    lo, hi = shard_bounds(pod["color0"].shape[-1], mesh.world, mesh.rank)
    return pod_to_tensors({k: v[..., lo:hi] for k, v in pod.items()}, mesh.device)


def _check_axis(mesh: Mesh, axis: str) -> None:
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r}: the mesh's axis is {mesh.axis!r}")


def _now(timings: dict | None, device) -> float:
    """The host clock; with `timings`, after waiting for the device."""
    if timings is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _tick(timings: dict | None, key: str, t0: float, device) -> float:
    """With `timings`, wait for the device and record the ms since t0 under
    key; returns the new start."""
    if timings is None:
        return t0
    t = _now(timings, device)
    timings[key] = (t - t0) * 1e3
    return t


def _run_edges(se: SortedEntries) -> torch.Tensor:
    """(n_tiles + 1,) int32 run edges of the sorted entries' tiles."""
    return torch.cat([se.tile_starts, se.tile_starts[-1:] + se.tile_counts[-1:]])


def _send_counts(se: SortedEntries, cfg: TileConfig, world: int, tiles_per_slab: int):
    """(world,) entries of each slab in this rank's sorted entries: the run
    edges at each slab's first tile, clamped to the screen (slabs past it
    are empty)."""
    first = torch.arange(world + 1, device=se.tile_starts.device) * tiles_per_slab
    bounds = _run_edges(se)[torch.clamp(first, max=cfg.n_tiles)].to(torch.int64)
    return bounds[1:] - bounds[:-1]


def _exchange_counts(send: torch.Tensor, e_cap: int, mesh: Mesh) -> np.ndarray:
    """Every rank's send counts and receive capacity -> (world, world + 1)
    int64 on the host: row i is rank i's counts to each owner, then its
    capacity. One all_to_all_single of world copies of this rank's row; the
    host read is the route's one sync."""
    row = torch.cat([send, torch.tensor([e_cap], dtype=torch.int64, device=send.device)])
    out = torch.empty(mesh.world * (mesh.world + 1), dtype=torch.int64, device=send.device)
    dist.all_to_all_single(out, row.repeat(mesh.world), group=mesh.group)
    return out.view(mesh.world, mesh.world + 1).cpu().numpy()


def _clamp_plan(mat: np.ndarray) -> tuple:
    """The capacity clamp of `render_sharded.py:179-192` of the JAX module
    over the (world, world + 1) count matrix -> (sizes (world, world):
    entries source i sends owner j, overflow: entries clamped in all).
    Owner j receives the runs in source order into its capacity; a run
    that does not fit is cut, and those after it get nothing."""
    s, cap = mat[:, :-1], mat[:, -1]
    off = np.cumsum(s, axis=0) - s
    sizes = np.minimum(s, cap[None, :] - np.minimum(off, cap[None, :]))
    return sizes, int((s - sizes).sum())


def _route_entries(entries: torch.Tensor, send: np.ndarray, sizes: np.ndarray,
                   mesh: Mesh) -> torch.Tensor:
    """Send each owner its (clamped) run of the sorted `entries` and
    receive this rank's slab runs, concatenated in source order: one
    all_to_all_single with exact split sizes, live entries only."""
    send_c, recv_c = sizes[mesh.rank], sizes[:, mesh.rank]
    if (send_c == send).all():
        data = entries
    else:
        starts = np.cumsum(send) - send
        data = torch.cat([entries[a:a + c] for a, c in zip(starts.tolist(), send_c.tolist())])
    out = torch.empty((int(recv_c.sum()), 4), dtype=torch.int32, device=entries.device)
    dist.all_to_all_single(out, data, output_split_sizes=recv_c.tolist(),
                           input_split_sizes=send_c.tolist(), group=mesh.group)
    return out


def _slab_entries(routed: torch.Tensor, cfg: TileConfig, slab_cfg: TileConfig,
                  slab_tile0: int) -> SortedEntries:
    """Owner side: one sort of the received runs (K2), then the slab's tile
    ranges from the GLOBAL-layout run edges, clamped to the real tiles (a
    slab past the screen gets empty ranges)."""
    se = sort_entries(routed, cfg)
    tiles = torch.arange(slab_tile0, slab_tile0 + slab_cfg.n_tiles + 1,
                         device=se.tile_starts.device)
    edges = _run_edges(se)[torch.clamp(tiles, max=cfg.n_tiles)]
    return se.ranged(edges[:-1].contiguous(), edges[1:] - edges[:-1])


def _frame_from_entries(entries: torch.Tensor, mesh: Mesh, cfg_key: TileConfig,
                        background, display_mode: int, capacity_factor: float,
                        timings: dict | None, t0: float) -> tuple:
    """Local sort, routing, owner sort, slab composite and the gather of the
    slabs -> ((padded_H, W, 3) image on every rank, overflow)."""
    slab_cfg, _, _ = slab_config(cfg_key, mesh.world)
    tiles_per_slab = slab_cfg.tiles_y * cfg_key.tiles_x
    dev = entries.device
    se = sort_entries(entries, cfg_key)
    send = _send_counts(se, cfg_key, mesh.world, tiles_per_slab)
    t0 = _tick(timings, "local_ms", t0, dev)
    e_cap = -(-int(capacity_factor * entries.shape[0]) // 128) * 128
    mat = _exchange_counts(send, e_cap, mesh)
    sizes, overflow = _clamp_plan(mat)
    t0 = _tick(timings, "counts_ms", t0, dev)
    routed = _route_entries(se.live(), mat[mesh.rank, :-1], sizes, mesh)
    t0 = _tick(timings, "all_to_all_ms", t0, dev)
    slab = _slab_entries(routed, cfg_key, slab_cfg, mesh.rank * tiles_per_slab)
    flat = display_mode != int(GaussianDisplayMode.SPLAT)
    img = over_background(composite_tiles_v2(slab, slab_cfg, flat_mode=flat), background)
    t0 = _tick(timings, "owner_ms", t0, dev)
    parts = [torch.empty_like(img) for _ in range(mesh.world)]
    dist.all_gather(parts, img.contiguous(), group=mesh.group)
    out = torch.cat(parts)
    _tick(timings, "gather_ms", t0, dev)
    return out, overflow


def render_frame_sharded(pod: dict, mesh: Mesh, axis: str, comp: Compressions,
                         cfg: TileConfig, view, proj, model, background, sh_degree: int = 3,
                         display_mode: int = 0, capacity_factor: float = 2.0,
                         timings: dict | None = None) -> tuple:
    """One model, sharded -> ((padded_H, W, 3) image, overflow) on every
    rank; image rows beyond cfg.height are blank. `pod`: this rank's shard
    (`shard_pod`).

    `capacity_factor` sizes each owner's receive capacity as factor x its
    entry slots (N_local * max_dup, in 128s); the overflow counts the live
    entries of all ranks that the clamp dropped this frame (0 in normal
    operation; > 0 means splats are missing: raise the factor).
    `timings`: filled with the ms of each stage (local front-end and sort,
    the count exchange and its read, the entries' all_to_all, the owner's
    sort and composite, the gather), each closed by a device sync."""
    _check_axis(mesh, axis)
    t0 = _now(timings, mesh.device)
    pre = preprocess_fused(pod, comp, view, proj, model, cfg.width, cfg.height,
                           sh_degree=sh_degree, display_mode=display_mode)
    entries = enumerate_entries_from_pre(pre, cfg)
    return _frame_from_entries(entries, mesh, cfg, background, display_mode, capacity_factor,
                               timings, t0)


def render_frame_sharded_multi(pods: tuple, mesh: Mesh, axis: str, comp: Compressions,
                               cfg: TileConfig, view, proj, models, ranks, background,
                               sh_degree: int = 3, display_mode: int = 0,
                               capacity_factor: float = 2.0,
                               timings: dict | None = None) -> tuple:
    """Sharded MERGED multi-model frame: every model's entries carry its
    model rank in the sort key (the viewer's merged frame: nearest model =
    rank 0), written into one entry buffer as `viewer.merged_entries` does,
    sorted by one K2 call and routed as in `render_frame_sharded`.

    pods: one shard (`shard_pod`) per model; models: (M, 4, 4) transforms;
    ranks: (M,) model ranks. Returns ((padded_H, W, 3), overflow)."""
    _check_axis(mesh, axis)
    t0 = _now(timings, mesh.device)
    mbits = max(1, (len(pods) - 1).bit_length())
    cfg_m = dataclasses.replace(cfg, model_bits=mbits)
    rows = [p["color0"].shape[-1] * cfg.max_dup for p in pods]
    entries = torch.empty((sum(rows), 4), dtype=torch.int32, device=mesh.device)
    start = 0
    for pod, model, rank, r in zip(pods, models, ranks, rows):
        if r:
            pre = preprocess_fused(pod, comp, view, proj, np.asarray(model, np.float32),
                                   cfg.width, cfg.height, sh_degree=sh_degree,
                                   display_mode=display_mode)
            enumerate_entries_from_pre(pre, cfg_m, model_rank=int(rank),
                                       out=entries[start:start + r])
        start += r
    return _frame_from_entries(entries, mesh, cfg_m, background, display_mode, capacity_factor,
                               timings, t0)


def render_sharded(pod: dict, mesh: Mesh, comp: Compressions, cfg: TileConfig, view, proj,
                   model=None, background=(0.0, 0.0, 0.0), sh_degree: int = 3,
                   display_mode: int = 0, axis: str = "splats", capacity_factor: float = 2.0,
                   return_stats: bool = False):
    """Convenience wrapper: (H, W, 3) cropped to the viewport, on every
    rank. With `return_stats`, (img, {"overflow": int}); the stats also
    feed `last_stats()`."""
    if model is None:
        model = np.eye(4, dtype=np.float32)
    img, overflow = render_frame_sharded(pod, mesh, axis, comp, cfg, view, proj, model,
                                         background, sh_degree=sh_degree,
                                         display_mode=display_mode,
                                         capacity_factor=capacity_factor)
    img = img[: cfg.height]
    _LAST["overflow"] = overflow
    _LAST["n_devices"] = mesh.world
    if return_stats:
        return img, {"overflow": overflow}
    return img
