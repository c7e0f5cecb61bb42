from .binning import (N_PLANES, PLANE_FIELDS, SENTINEL, EntryPlanes, SortedEntries, TileConfig,
                      TileLists, build_entry_planes, build_sorted_entries, build_tile_lists,
                      enumerate_entries_from_pre, enumerate_entries_from_pre_plain)
from .composite import (composite_tiles, composite_tiles_plain, composite_tiles_plain_v2,
                        composite_tiles_v2, over_background)
from .fused import (build_sorted_entries_fused, enumerate_entries_fused, enumerate_entries_plain,
                    preprocess_fused, preprocess_geometry_fused, preprocess_geometry_plain)
from .overlay import draw_overlays, overlay_cuda
from .preprocess import PreprocessOut, preprocess
from .sort import sort_entries, sort_entries_plain

__all__ = [
    "N_PLANES",
    "PLANE_FIELDS",
    "SENTINEL",
    "EntryPlanes",
    "SortedEntries",
    "TileConfig",
    "TileLists",
    "build_entry_planes",
    "build_sorted_entries",
    "build_tile_lists",
    "enumerate_entries_from_pre",
    "enumerate_entries_from_pre_plain",
    "composite_tiles",
    "composite_tiles_plain",
    "composite_tiles_plain_v2",
    "composite_tiles_v2",
    "over_background",
    "build_sorted_entries_fused",
    "enumerate_entries_fused",
    "enumerate_entries_plain",
    "preprocess_fused",
    "preprocess_geometry_fused",
    "preprocess_geometry_plain",
    "draw_overlays",
    "overlay_cuda",
    "PreprocessOut",
    "preprocess",
    "sort_entries",
    "sort_entries_plain",
]
