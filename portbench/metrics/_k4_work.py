"""The work of the query geometry kernel K4 (`csrc/geometry.cu`, the
SH-less instance of `geometry_kernel`) for one launch: what the queries
need of it, not what its buffers hold.

Read, once a splat: the position (3 f32), the covariance (6 f16, or 6 f32
uncompressed) and the packed colour word, whose alpha the opacity cull and
the opacity-aware extent need; and the mask bit (one byte) where the mask
gates it. Written, once a splat: the projected centre x and y (f32) and
the valid flag (one byte), which is all a rect, brush or texture query
reads. K4 writes all 11 planes of a PreprocessOut today (depth, conic,
radius and colour too); they are left out on purpose, so that a K4 that
writes only what the queries read is not counted as doing less of the
work. Operations: ~170 a splat (the covariance decode, the model-view
and projection transforms, the 2D covariance, its conic and radius, the
opacity-aware extent and the culls: K1's 230 less the colour, SH and
entry work); they bound nothing here, the bytes do."""

POS_BYTES = 12
COV_BYTES = {"single": 24, "half": 12}
COLOR_BYTES = 4
MASK_BYTES = 1
OUT_BYTES = 4 + 4 + 1     # centre x, centre y, valid
OPS_SPLAT = 170


def k4(splats: int, cov3d: str, masked: bool) -> tuple:
    """(bytes, operations) of one K4 launch over `splats` splats."""
    read = POS_BYTES + COV_BYTES[cov3d] + COLOR_BYTES + (MASK_BYTES if masked else 0)
    return splats * (read + OUT_BYTES), splats * OPS_SPLAT
