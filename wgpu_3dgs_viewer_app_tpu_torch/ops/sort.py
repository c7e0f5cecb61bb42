"""Entry sort: live entries ascending by u32 key, payloads attached, plus
the per-tile run edges.

`sort_entries` is the counterpart of the JAX package's sort chain
(`ops/compact.py` -> `ops/sort.py` block sort -> merge levels, then the
searchsorted of `ops/binning.py`). On CUDA entries it launches kernel K2
(`csrc/sort.cu`): one upfront read that counts the live entries and builds
every digit histogram, four one-sweep stable radix passes (the first also
compacts) and the tile edges, with the live count left on the device. On CPU entries it runs the plain version,
`sort_entries_plain`: `torch.sort(stable=True)` of the live keys and a
gather. Both return the live entries only, equal keys in slot order, so
the two agree entry for entry (`testing.compare_sorted(stable=True)`).
It also takes the role of the reference's `sort_and_range_entries`: the
merged multi-model frame hands it all models' entries and the config with
the rank field; the keys sort as whole 32-bit words and the tile edges are
read at `cfg._tile_shift`, so the rank needs nothing more here. The v1
chain (`binning.build_tile_lists`) sorts its (key, splat index, 0, 0)
slots here too and reads the edges at `cfg.depth_bits`.
"""

from __future__ import annotations

import torch

from ..core.f16 import u32
from . import kernels
from .binning import (SENTINEL, SortedEntries, TileConfig, sorted_entries_from_edges,
                      tile_edges_plain)

_META_LIVE = 4 * 256  # K2's meta buffer: four 256-bin histograms, then the live count


def sort_entries_plain(entries: torch.Tensor, cfg: TileConfig,
                       shift: int | None = None) -> SortedEntries:
    """Plain version of K2: drop sentinel slots, sort by unsigned key
    (stable), tile edges at bit `shift` (default `cfg._tile_shift`)."""
    keys = u32(entries[:, 0])
    live = keys != SENTINEL
    order = torch.sort(keys[live], stable=True).indices
    entries = entries[live][order]
    shift = cfg._tile_shift if shift is None else shift
    return sorted_entries_from_edges(entries, tile_edges_plain(entries[:, 0], cfg, shift), cfg)


def sort_buffers(n: int, n_tiles: int, device) -> dict:
    """What K2 writes sorting n slots into `n_tiles` tiles: the meta words
    (histograms, live count, digit starts), the two entry buffers, the
    look-back status, the tickets, the run edges and the tile counts. A
    caller that sorts every frame keeps one set (`sort_entries(bufs=)`, for
    n slots or fewer)."""
    lib = kernels.library()
    i32 = torch.int32
    return {"meta": torch.empty(lib.gs_sort_meta_words(), dtype=i32, device=device),
            "a": torch.empty((n, 4), dtype=i32, device=device),
            "b": torch.empty((n, 4), dtype=i32, device=device),
            "status": torch.empty(2 * max(lib.gs_sort_num_tiles(n), 1) * 256, dtype=i32,
                                  device=device),
            "tickets": torch.empty(4, dtype=i32, device=device),
            "edges": torch.empty(n_tiles + 1, dtype=i32, device=device),
            "counts": torch.empty(n_tiles, dtype=i32, device=device)}


def _sort_entries_cuda(entries: torch.Tensor, cfg: TileConfig, shift: int,
                       bufs: dict | None) -> SortedEntries:
    lib = kernels.library()
    n = entries.shape[0]
    kernels.require(entries, "entries", torch.int32, (n, 4))
    if bufs is None:
        bufs = sort_buffers(n, cfg.n_tiles, entries.device)
    if bufs["a"].shape[0] < n or bufs["status"].numel() < 2 * lib.gs_sort_num_tiles(n) * 256:
        raise ValueError(f"sort buffers for {bufs['a'].shape[0]} slots, not {n}")
    kernels.require(bufs["edges"], "edges", torch.int32, (cfg.n_tiles + 1,), entries.device)
    a, b = bufs["a"][:n], bufs["b"][:n]
    p = kernels.ptr
    kernels.check(lib.gs_sort(p(entries), n, p(bufs["meta"]), p(a), p(b), p(bufs["status"]),
                              p(bufs["tickets"]), shift, cfg.n_tiles, p(bufs["edges"]),
                              kernels.stream()), "gs_sort")
    kernels.LAUNCHES["sort"] += 1
    edges = bufs["edges"]
    counts = torch.sub(edges[1:], edges[:-1], out=bufs["counts"])
    return SortedEntries(entries=a, tile_starts=edges[:-1], tile_counts=counts,
                         n_valid=bufs["meta"][_META_LIVE:_META_LIVE + 1])


def sort_entries(entries: torch.Tensor, cfg: TileConfig, shift: int | None = None,
                 bufs: dict | None = None) -> SortedEntries:
    """(E, 4) int32 entries -> SortedEntries: kernel K2 on CUDA, the plain
    version on the CPU. The tile edges are read at key bit `shift`
    (default `cfg._tile_shift`, the v2 layout). On a card the host issues
    the sort and goes on: the live count stays on the device (the result's
    `n_valid` reads it when asked), and K2 writes into `bufs`
    (`sort_buffers(E, cfg.n_tiles)`) where given, else into new ones."""
    if entries.device.type == "cpu":
        return sort_entries_plain(entries, cfg, shift)
    return _sort_entries_cuda(entries, cfg, cfg._tile_shift if shift is None else shift, bufs)
