"""The work of a frame's stages, from the frame itself, and the least time
the card could do it in.

Each count takes only what the frame needs: the splats it reads, the
entries that are live, the blends before each pixel's exit. None depends
on the buffers of whatever implements a stage (its slot capacity, its
scratch), so a later change of layout leaves the yardstick as it is.
Operations per unit of work are counted from the stages' arithmetic:
the front-end ~230 per splat (decode, transforms, EWA, extent, cull,
pack) plus 4 per SH coefficient and channel and 40 per live entry; the
sort ~34 integer operations per live entry; the compositor 22 per blend."""

from __future__ import annotations

import json

from .spec import HERE

K1_OPS_SPLAT, K1_OPS_SH, K1_OPS_ENTRY = 230, 4, 40
K2_OPS_ENTRY = 34
K3_OPS_BLEND = 22
ENTRY_BYTES = 16          # one entry: key and three payload words
PIXEL_BYTES = 16          # the compositor's premultiplied rgba, f32
TILE_RANGE_BYTES = 8      # a tile's start and count, int32 each
SH_COEFFS = {0: 0, 1: 3, 2: 8, 3: 15}


def peaks() -> dict:
    with open(HERE / "peaks.json") as f:
        return json.load(f)


def pod_bytes_per_splat(sh: str, cov3d: str, sh_degree: int) -> int:
    """Bytes of one splat that the front-end reads: position (12), packed
    colour (4), covariance (24 f32, 12 f16) and the SH rest terms of the
    degree drawn (f32 4, f16 2, norm8 1 a value, norm8 plus its range 8)."""
    cov = {"single": 24, "half": 12}[cov3d]
    vals = 3 * SH_COEFFS[sh_degree]
    shb = {"single": 4 * vals, "half": 2 * vals, "norm8": vals + 8, "remove": 0}[sh]
    return 12 + 4 + cov + (shb if vals else 0)


def k1(splats: int, live_entries: int, pod_bytes: int, sh_degree: int) -> tuple:
    """(bytes, operations) of the front-end: the frame's splats read once,
    its live entries written once."""
    ops = splats * (K1_OPS_SPLAT + K1_OPS_SH * 3 * SH_COEFFS[sh_degree])
    return splats * pod_bytes + live_entries * ENTRY_BYTES, ops + K1_OPS_ENTRY * live_entries


def k2(live_entries: int, n_tiles: int) -> tuple:
    """(bytes, operations) of the entry sort: the live entries read once
    and written once, and the tile ranges written."""
    return 2 * live_entries * ENTRY_BYTES + n_tiles * TILE_RANGE_BYTES, K2_OPS_ENTRY * live_entries


def k3(blends: int, entries_read: int, pixels: int) -> tuple:
    """(bytes, operations) of the compositor: the entries consumed before
    the pixels' exits read once, the image written once, the blends."""
    return entries_read * ENTRY_BYTES + pixels * PIXEL_BYTES, K3_OPS_BLEND * blends


def bound_s(work: tuple, pk: dict | None = None) -> tuple:
    """(seconds, 'bytes' or 'operations'): the larger of bytes over HBM
    bandwidth and operations over the f32 rate."""
    pk = pk or peaks()
    b = work[0] / pk["hbm_bytes_per_s"]
    o = work[1] / pk["f32_ops_per_s"]
    return (b, "bytes") if b >= o else (o, "operations")
