"""Entry sort: live entries ascending by u32 key, payloads attached, plus
the per-tile run edges.

`sort_entries` is the counterpart of the JAX package's sort chain
(`ops/compact.py` -> `ops/sort.py` block sort -> merge levels, then the
searchsorted of `ops/binning.py`). On CUDA entries it launches kernel K2
(`csrc/sort.cu`): live-entry compaction, a stable 4-pass LSD radix sort of
the 16-byte entries, and the tile edges. On CPU entries it runs the plain
version, `sort_entries_plain`: `torch.sort` of the live keys and a gather.
Both return the live entries only; tie order is not part of the contract.
"""

from __future__ import annotations

import torch

from ..core.f16 import u32
from . import kernels
from .binning import (SENTINEL, SortedEntries, TileConfig, sorted_entries_from_edges,
                      tile_edges_plain)


def sort_entries_plain(entries: torch.Tensor, cfg: TileConfig) -> SortedEntries:
    """Plain version of K2: drop sentinel slots, sort by unsigned key."""
    keys = u32(entries[:, 0])
    live = keys != SENTINEL
    order = torch.sort(keys[live], stable=True).indices
    entries = entries[live][order]
    return sorted_entries_from_edges(entries, tile_edges_plain(entries[:, 0], cfg), cfg)


def _sort_entries_cuda(entries: torch.Tensor, cfg: TileConfig) -> SortedEntries:
    lib = kernels.library()
    n = entries.shape[0]
    kernels.require(entries, "entries", torch.int32, (n, 4))
    dev, i32, st, p = entries.device, torch.int32, kernels.stream(), kernels.ptr
    nb = lib.gs_sort_num_blocks(n)
    offsets = torch.empty(max(nb, 1), dtype=i32, device=dev)
    total = torch.empty(1, dtype=i32, device=dev)
    kernels.check(lib.gs_sort_count_live(p(entries), n, p(offsets), p(total), st),
                  "gs_sort_count_live")
    # The live count sizes the sort buffers: one device->host read per frame.
    n_live = int(total.item())
    buf_a = torch.empty((n_live, 4), dtype=i32, device=dev)
    buf_b = torch.empty((n_live, 4), dtype=i32, device=dev)
    hist = torch.empty(max(lib.gs_sort_num_blocks(n_live), 1) * 256, dtype=i32, device=dev)
    digit_total = torch.empty(256, dtype=i32, device=dev)
    kernels.check(lib.gs_sort_compact_radix(p(entries), n, p(offsets), p(buf_a), p(buf_b),
                                            n_live, p(hist), p(digit_total), st),
                  "gs_sort_compact_radix")
    edges = torch.zeros(cfg.n_tiles + 1, dtype=i32, device=dev)
    kernels.check(lib.gs_sort_tile_edges(p(buf_a), n_live, cfg._tile_shift, cfg.n_tiles,
                                         p(edges), st), "gs_sort_tile_edges")
    kernels.LAUNCHES["sort"] += 1
    return SortedEntries(entries=buf_a, tile_starts=edges[:-1],
                         tile_counts=edges[1:] - edges[:-1], n_valid=n_live)


def sort_entries(entries: torch.Tensor, cfg: TileConfig) -> SortedEntries:
    """(E, 4) int32 entries -> SortedEntries: kernel K2 on CUDA, the plain
    version on the CPU."""
    if entries.device.type == "cpu":
        return sort_entries_plain(entries, cfg)
    return _sort_entries_cuda(entries, cfg)
