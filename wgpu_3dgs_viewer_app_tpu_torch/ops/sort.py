"""Entry sort: live entries ascending by u32 key, payloads attached, plus
the per-tile run edges.

`sort_entries` is the counterpart of the JAX package's sort chain
(`ops/compact.py` -> `ops/sort.py` block sort -> merge levels, then the
searchsorted of `ops/binning.py`). On CUDA entries it launches kernel K2
(`csrc/sort.cu`): one upfront read that counts the live entries and builds
every digit histogram, four one-sweep stable radix passes (the first also
compacts) and the tile edges. On CPU entries it runs the plain version,
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
from ..utils import trace
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


def _sort_entries_cuda(entries: torch.Tensor, cfg: TileConfig, shift: int) -> SortedEntries:
    lib = kernels.library()
    n = entries.shape[0]
    kernels.require(entries, "entries", torch.int32, (n, 4))
    dev, i32, st, p = entries.device, torch.int32, kernels.stream(), kernels.ptr
    meta = torch.empty(lib.gs_sort_meta_words(), dtype=i32, device=dev)
    kernels.check(lib.gs_sort_upfront(p(entries), n, p(meta), st), "gs_sort_upfront")
    # The live count sizes the sort buffers: one device->host read per frame.
    with trace.host_read():
        n_live = int(meta[_META_LIVE].item())
    buf_a = torch.empty((n_live, 4), dtype=i32, device=dev)
    buf_b = torch.empty((n_live, 4), dtype=i32, device=dev)
    status = torch.empty(max(lib.gs_sort_num_tiles(n), 1) * 256, dtype=i32, device=dev)
    tickets = torch.empty(4, dtype=i32, device=dev)
    kernels.check(lib.gs_sort_onesweep(p(entries), n, p(buf_a), p(buf_b), n_live, p(meta),
                                       p(status), p(tickets), st), "gs_sort_onesweep")
    edges = torch.zeros(cfg.n_tiles + 1, dtype=i32, device=dev)
    kernels.check(lib.gs_sort_tile_edges(p(buf_a), n_live, shift, cfg.n_tiles, p(edges), st),
                  "gs_sort_tile_edges")
    kernels.LAUNCHES["sort"] += 1
    return SortedEntries(entries=buf_a, tile_starts=edges[:-1],
                         tile_counts=edges[1:] - edges[:-1], n_valid=n_live)


def sort_entries(entries: torch.Tensor, cfg: TileConfig,
                 shift: int | None = None) -> SortedEntries:
    """(E, 4) int32 entries -> SortedEntries: kernel K2 on CUDA, the plain
    version on the CPU. The tile edges are read at key bit `shift`
    (default `cfg._tile_shift`, the v2 layout)."""
    if entries.device.type == "cpu":
        return sort_entries_plain(entries, cfg, shift)
    return _sort_entries_cuda(entries, cfg, cfg._tile_shift if shift is None else shift)
