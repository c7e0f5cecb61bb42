"""Streaming PLY reader/writer for Inria 3DGS splats (host-side numpy).

Same behaviour as `wgpu_3dgs_viewer_app_tpu.data.ply`: header-first parsing,
chunked binary decode through a structured dtype, an ASCII fallback, and
per-record fault tolerance (non-finite or unparseable records are skipped
and counted, a truncated tail yields the valid remainder).
"""

from __future__ import annotations

import dataclasses
import io
from typing import BinaryIO, Iterator, Optional

import numpy as np

from .gaussian import PLY_GAUSSIAN_POD_DTYPE, PLY_PROPERTIES, Gaussians


class PlyError(ValueError):
    """PLY parse failure."""


_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
}


@dataclasses.dataclass
class PlyHeader:
    count: int
    fmt: str  # "binary_little_endian" | "binary_big_endian" | "ascii"
    properties: list  # [(name, np dtype str)]
    header_len: int  # bytes consumed by the header

    @property
    def dtype(self) -> np.dtype:
        return np.dtype([(n, t) for n, t in self.properties])


def read_ply_header(reader: BinaryIO) -> PlyHeader:
    """Parse the PLY header, leaving the reader at the first vertex byte."""
    line = reader.readline()
    consumed = len(line)
    if line.strip() != b"ply":
        raise PlyError("not a PLY file (missing 'ply' magic)")
    fmt = None
    count = None
    properties: list = []
    in_vertex = False
    while True:
        line = reader.readline()
        if not line:
            raise PlyError("unexpected EOF in PLY header")
        consumed += len(line)
        parts = line.decode("ascii", "replace").strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                count = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise PlyError("list properties are not supported for splat PLYs")
            np_t = _PLY_TO_NP.get(parts[1])
            if np_t is None:
                raise PlyError(f"unsupported property type {parts[1]!r}")
            properties.append((parts[2], np_t))
        elif parts[0] == "end_header":
            break
    if fmt is None or count is None:
        raise PlyError("malformed PLY header (missing format/element)")
    missing = [p for p in PLY_PROPERTIES if p not in {n for n, _ in properties}]
    if missing:
        raise PlyError(f"PLY missing required 3DGS properties: {missing[:5]}...")
    return PlyHeader(count=count, fmt=fmt, properties=properties, header_len=consumed)


@dataclasses.dataclass
class PlyReadStats:
    """Per-record fault tolerance counters."""

    skipped: int = 0    # malformed records dropped (non-finite / unparseable)
    truncated: int = 0  # records missing: EOF before the declared count

    @property
    def dropped(self) -> int:
        return self.skipped + self.truncated


def _records_to_gaussians(records: np.ndarray, stats: Optional[PlyReadStats]):
    """Arbitrary-property records -> `Gaussians`, dropping non-finite records."""
    pods = np.empty(len(records), PLY_GAUSSIAN_POD_DTYPE)
    for name in PLY_PROPERTIES:
        pods[name] = records[name].astype(np.float32)
    keep = np.isfinite(pods.view(np.float32).reshape(len(pods), -1)).all(axis=1)
    n_bad = int(len(pods) - keep.sum())
    if n_bad:
        if stats is not None:
            stats.skipped += n_bad
        pods = pods[keep]
    return Gaussians.from_pod_records(pods) if len(pods) else None


def read_ply_chunks(
    reader: BinaryIO,
    header: PlyHeader,
    chunk_size: int = 65536,
    stats: Optional[PlyReadStats] = None,
) -> Iterator[Gaussians]:
    """Stream the vertex data as `Gaussians` chunks."""
    if header.fmt == "ascii":
        yield from _read_ascii_chunks(reader, header, chunk_size, stats)
        return
    dtype = header.dtype
    if header.fmt == "binary_big_endian":
        dtype = dtype.newbyteorder(">")
    remaining = header.count
    while remaining > 0:
        n = min(chunk_size, remaining)
        buf = reader.read(n * dtype.itemsize)
        if len(buf) < n * dtype.itemsize:
            n_have = len(buf) // dtype.itemsize
            if n_have == 0 and remaining == header.count:
                raise PlyError("unexpected EOF in PLY vertex data")
            if stats is not None:
                stats.truncated += remaining - n_have
            buf = buf[: n_have * dtype.itemsize]
            n = remaining = n_have  # exit after yielding what we have
            if n == 0:
                return
        records = np.frombuffer(buf, dtype=dtype, count=n)
        if header.fmt == "binary_big_endian":
            records = records.astype(header.dtype)
        chunk = _records_to_gaussians(records, stats)
        if chunk is not None:
            yield chunk
        remaining -= n


def _read_ascii_chunks(reader, header: PlyHeader, chunk_size: int,
                       stats: Optional[PlyReadStats] = None):
    names = [n for n, _ in header.properties]
    nf = len(names)
    remaining = header.count
    rows = []

    def flush():
        arr = np.asarray(rows, np.float32)
        rec = np.rec.fromarrays([arr[:, i] for i in range(nf)], names=names,
                                formats=["<f4"] * nf)
        return _records_to_gaussians(rec, stats)

    for line in reader:
        if remaining == 0:
            break
        vals = line.split()
        if not vals:
            continue
        remaining -= 1
        try:
            if len(vals) != nf:
                raise ValueError
            rows.append([float(v) for v in vals])
        except ValueError:
            if stats is not None:
                stats.skipped += 1
            continue
        if len(rows) >= chunk_size:
            chunk = flush()
            if chunk is not None:
                yield chunk
            rows = []
    if stats is not None and remaining > 0:
        stats.truncated += remaining
    if rows:
        chunk = flush()
        if chunk is not None:
            yield chunk


def read_ply(path_or_reader, stats: Optional[PlyReadStats] = None) -> Gaussians:
    """Read a whole PLY into one `Gaussians`."""
    if isinstance(path_or_reader, (str, bytes)):
        with open(path_or_reader, "rb") as f:
            return read_ply(f, stats)
    header = read_ply_header(path_or_reader)
    chunks = list(read_ply_chunks(path_or_reader, header, stats=stats))
    if not chunks:
        return Gaussians.empty(0)
    return Gaussians.concat(chunks)


def write_ply(
    writer: BinaryIO,
    g: Gaussians,
    edits: Optional[tuple] = None,
    mask: Optional[np.ndarray] = None,
) -> int:
    """Write splats as binary-little-endian Inria PLY; returns the count
    written. `mask` is an optional per-splat keep mask."""
    if edits is not None:
        raise NotImplementedError(
            "baking per-splat edits into an export waits for the core/edit "
            "port (ROADMAP queue A)")
    out = g
    if mask is not None:
        keep = np.asarray(mask).astype(bool)
        if not keep.all():
            out = g.select(keep)
    header = io.BytesIO()
    header.write(b"ply\nformat binary_little_endian 1.0\n")
    header.write(f"element vertex {out.count}\n".encode())
    for name in PLY_PROPERTIES:
        header.write(f"property float {name}\n".encode())
    header.write(b"end_header\n")
    writer.write(header.getvalue())
    writer.write(memoryview(out.to_pod_records()).cast("B"))
    return out.count
