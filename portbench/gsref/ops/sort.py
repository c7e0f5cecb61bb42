"""Entry sort, a frozen copy of the port's plain sort: live entries
ascending by u32 key (stable), payloads attached, plus the per-tile run
edges."""

from __future__ import annotations

import torch

from ..core.f16 import u32
from .binning import SENTINEL, SortedEntries, TileConfig, sorted_entries_from_edges, tile_edges_plain


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

