"""Single- and multi-model viewer, the counterpart of
`wgpu_3dgs_viewer_app_tpu.viewer.viewer`.

One model's frame runs the kernel path: front-end K1 -> entry sort K2 ->
compositor K3 on a CUDA device, their plain versions on the CPU. The
editing state (mask, per-splat edits, the scene-wide selection edit and
highlight) rides K1's gating inputs; only the gates a model's buffers hold
are passed, so a scene never edited renders through the ungated front-end.
Models are ordered back-to-front by the camera distance of their centres.
A frame with more than one visible model needs the merged multi-model pass,
which waits for a later slice (ROADMAP queue A).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraTrait
from ..core.edit import GaussianEditPod, SelectionHighlightPod
from ..core.transform import GaussianDisplayMode, GaussianTransform, ModelTransform
from ..data.compression import Compressions
from ..data.gaussian import Gaussians
from ..ops.binning import TileConfig
from ..ops.composite import composite_tiles_v2, over_background
from ..ops.fused import build_sorted_entries_fused
from .buffers import GaussianBuffers


class ViewerModel:
    """One model slot: buffers + transform + visibility."""

    def __init__(self, file_name: str, capacity: int, comp: Compressions, device):
        self.file_name = file_name
        self.buffers = GaussianBuffers(capacity, comp, device)
        self.transform = ModelTransform()
        self.visible = True
        self.center = np.zeros(3, np.float32)
        self.gaussians: Optional[Gaussians] = None  # host copy (export path)

    def set_gaussians(self, g: Gaussians) -> None:
        self.gaussians = g
        self.center = g.center()
        self.buffers.upload_all(g)


class MultiModelViewer:
    """Scene-level viewer: models, world state and the render loop."""

    def __init__(
        self,
        width: int,
        height: int,
        comp: Compressions = Compressions(),
        # Product default: tile 32, max_dup 4 (exact for splats spanning
        # <= 2x2 tiles; larger ones lose far cells centre-out).
        tile: int = 32,
        max_dup: int = 4,
        background=(0.0, 0.0, 0.0),
        device="cuda",
    ):
        self.cfg = TileConfig(width, height, tile=tile, max_dup=max_dup)
        self.comp = comp
        self.device = torch.device(device)
        self.models: dict[str, ViewerModel] = {}
        self.gaussian_transform = GaussianTransform()
        self.selection_edit: Optional[GaussianEditPod] = None
        self.highlight = SelectionHighlightPod()
        self.show_highlight = False
        self.background = np.asarray(background, np.float32)
        self._view = np.eye(4, dtype=np.float32)
        self._proj = np.eye(4, dtype=np.float32)
        self._cam_pos = np.zeros(3, np.float32)

    # --- model management ---------------------------------------------------

    def add_model(self, key: str, g: Gaussians, capacity: Optional[int] = None) -> ViewerModel:
        key = self.dedup_key(key)
        m = ViewerModel(key, capacity or g.count, self.comp, self.device)
        m.set_gaussians(g)
        self.models[key] = m
        return m

    def dedup_key(self, key: str) -> str:
        """Duplicate names become `name (n)`."""
        if key not in self.models:
            return key
        i = 1
        while f"{key} ({i})" in self.models:
            i += 1
        return f"{key} ({i})"

    def remove_model(self, key: str) -> None:
        """Refuses to remove the last model."""
        if len(self.models) <= 1:
            raise ValueError("cannot remove the last model")
        del self.models[key]

    # --- world state ----------------------------------------------------------

    def update_camera(self, camera: CameraTrait) -> None:
        self._view = np.asarray(camera.view(), np.float32)
        self._proj = np.asarray(camera.projection(self.cfg.width / self.cfg.height), np.float32)
        self._cam_pos = np.asarray(camera.pos, np.float32)

    def update_selection_edit(self, pod: Optional[GaussianEditPod]) -> None:
        self.selection_edit = pod

    def update_selection_highlight(self, pod: SelectionHighlightPod, show: bool = True) -> None:
        self.highlight = pod
        self.show_highlight = show

    # --- rendering --------------------------------------------------------------

    def model_order(self) -> list:
        """Visible non-empty model keys, back-to-front by centre distance."""
        keys = [k for k, m in self.models.items() if m.visible and len(m.buffers) > 0]

        def depth(k):
            mat = self.models[k].transform.matrix()
            c = mat[:3, :3] @ self.models[k].center + mat[:3, 3]
            return float(np.linalg.norm(c - self._cam_pos))

        return sorted(keys, key=depth, reverse=True)

    def render_model(self, key: str, show_unedited: bool = False) -> torch.Tensor:
        """One model -> (H, W, 4) premultiplied rgba on the viewer's device.
        `show_unedited` drops the edits (per-splat and selection) but keeps
        the mask and the highlight."""
        m = self.models[key]
        gt = self.gaussian_transform
        entries = build_sorted_entries_fused(
            m.buffers.pod, self.comp, self.cfg, self._view, self._proj, m.transform.matrix(),
            sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0, size=gt.size,
            display_mode=int(gt.display_mode), **self._gating_kwargs(m, show_unedited),
        )
        flat = gt.display_mode != GaussianDisplayMode.SPLAT
        return composite_tiles_v2(entries, self.cfg, flat_mode=flat)

    def _gating_kwargs(self, m: ViewerModel, show_unedited: bool) -> dict:
        """The gates the model's buffers hold, for the front-end (gates never
        set are left out)."""
        b = m.buffers
        kw = {}
        if b.mask is not None:
            kw["mask_bits"] = b.mask
        if b.edit_flags is not None and not show_unedited:
            kw["edit"] = (b.edit_flags, b.edit_rgb, b.edit_params)
        if b.selection is not None:
            if self.selection_edit is not None and not show_unedited:
                kw["selection_edit"] = self.selection_edit.as_arrays()
            if self.show_highlight:
                kw["highlight_rgba"] = np.asarray(self.highlight.rgba, np.float32)
            if kw.keys() & {"selection_edit", "highlight_rgba"}:
                kw["selection_bits"] = b.selection
        return kw

    def render(self, camera: Optional[CameraTrait] = None,
               show_unedited: bool = False) -> torch.Tensor:
        """Full frame -> (H, W, 3) f32 over the background."""
        if camera is not None:
            self.update_camera(camera)
        order = self.model_order()
        if not order:
            bg = torch.as_tensor(self.background, device=self.device)
            return bg.expand(self.cfg.height, self.cfg.width, 3).clone()
        if len(order) > 1:
            raise NotImplementedError(
                "frames with several visible models need the merged multi-model pass "
                "(model rank in the key), which waits for a later slice (ROADMAP queue A)")
        return over_background(self.render_model(order[0], show_unedited), self.background)


class Viewer(MultiModelViewer):
    """Single-model convenience viewer."""

    def __init__(self, g: Gaussians, width: int, height: int, **kw):
        super().__init__(width, height, **kw)
        self.add_model("model", g)
