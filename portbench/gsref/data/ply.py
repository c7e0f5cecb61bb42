"""The Inria 3DGS PLY writer (binary little endian), a frozen copy of the
port's `data.ply.write_ply`: the benchmark writes the session cells' scene
as PLY bytes in memory with it."""

from __future__ import annotations

import io
from typing import BinaryIO

from .gaussian import PLY_PROPERTIES, Gaussians


def write_ply(writer: BinaryIO, g: Gaussians) -> int:
    """Write splats as binary-little-endian Inria PLY; returns the count
    written."""
    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {g.count}\n".encode())
    for name in PLY_PROPERTIES:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    writer.write(header.getvalue())
    writer.write(memoryview(g.to_pod_records()).cast("B"))
    return g.count
