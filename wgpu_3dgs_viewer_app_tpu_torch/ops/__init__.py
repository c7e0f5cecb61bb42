from .binning import SENTINEL, SortedEntries, TileConfig, enumerate_entries_from_pre
from .composite import composite_tiles_plain_v2, composite_tiles_v2, over_background
from .fused import build_sorted_entries_fused, enumerate_entries_fused, enumerate_entries_plain
from .preprocess import PreprocessOut, preprocess
from .sort import sort_entries, sort_entries_plain

__all__ = [
    "SENTINEL",
    "SortedEntries",
    "TileConfig",
    "enumerate_entries_from_pre",
    "composite_tiles_plain_v2",
    "composite_tiles_v2",
    "over_background",
    "build_sorted_entries_fused",
    "enumerate_entries_fused",
    "enumerate_entries_plain",
    "PreprocessOut",
    "preprocess",
    "sort_entries",
    "sort_entries_plain",
]
