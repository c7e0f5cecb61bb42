"""Export: PLY write-back with baked edits and the mask filter, one model
as a bare PLY, several as a ZIP of PLYs.

Counterpart of `wgpu_3dgs_viewer_app_tpu.app.export`: per model the
choices {export, with edits, with mask}; the edit and mask sidecars are
downloaded from the device, the splats come from the model's host copy.
"""

from __future__ import annotations

import dataclasses
import io
import zipfile
from typing import BinaryIO, Dict

from ..data.ply import write_ply
from ..viewer.viewer import MultiModelViewer


@dataclasses.dataclass
class ExportChoice:
    export: bool = True
    with_edit: bool = True
    with_mask: bool = True


def snapshot_exports(viewer: MultiModelViewer,
                     choices: Dict[str, ExportChoice] | None = None) -> list:
    """Capture (name, gaussians, edits, mask) per exported model: the
    device sidecars are downloaded here, the serialization is
    `serialize_exports`."""
    choices = choices or {k: ExportChoice() for k in viewer.models}
    snap = []
    for key, c in choices.items():
        if not (c.export and key in viewer.models):
            continue
        m = viewer.models[key]
        if m.gaussians is None:
            raise ValueError(f"model {key!r} has no CPU gaussians to export")
        edits = m.buffers.download_edits() if c.with_edit else None
        mask = m.buffers.download_mask() if c.with_mask else None
        snap.append((key, m.gaussians, edits, mask))
    return snap


def serialize_exports(snap: list, writer: BinaryIO) -> list:
    """Write a `snapshot_exports` capture: one model as raw PLY bytes,
    several as a deflate ZIP with one `<name>.ply` each. Returns the names."""
    if not snap:
        return []
    if len(snap) == 1:
        key, g, edits, mask = snap[0]
        write_ply(writer, g, edits=edits, mask=mask)
        return [key]
    with zipfile.ZipFile(writer, "w", compression=zipfile.ZIP_DEFLATED) as zf:
        for key, g, edits, mask in snap:
            buf = io.BytesIO()
            write_ply(buf, g, edits=edits, mask=mask)
            name = key if key.endswith(".ply") else f"{key}.ply"
            zf.writestr(name, buf.getvalue())
    return [s[0] for s in snap]


def export_models(viewer: MultiModelViewer, writer: BinaryIO,
                  choices: Dict[str, ExportChoice] | None = None) -> list:
    """Export the chosen models; returns the exported names."""
    return serialize_exports(snapshot_exports(viewer, choices), writer)
