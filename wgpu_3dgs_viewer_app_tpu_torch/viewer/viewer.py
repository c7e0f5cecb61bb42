"""Single- and multi-model viewer, the counterpart of
`wgpu_3dgs_viewer_app_tpu.viewer.viewer`.

A frame is front-end -> entry sort K2 -> compositor K3 on a CUDA device,
their plain versions on the CPU. The front-end has two routes, picked by the
viewer's `fused` switch (the counterpart of the reference's `use_pallas`):
fused, kernel K1 straight from the pod; or staged, `preprocess_fused`
(kernel K8) then the enumerate-and-pack kernel K5 (`render_frame` is that
pipeline for one model). The editing state (mask, per-splat edits, the
scene-wide selection edit and highlight) rides the front-end's gating
inputs; only the gates a model's buffers hold are passed, so a scene never
edited renders ungated.

Models are ordered back-to-front by the camera distance of their centres.
A frame with several visible models is one merged pass: every model's
entries carry its rank in the sort key (nearest = 0, `TileConfig.model_bits`
wide), written into one entry buffer, so one sort and one composite equal
the per-model frames blended back to front (the over operator is
associative).

On a card the fused route's `render` issues the frame through
`graph.FrameGraphs`: one frame buffer set per viewer, the frame's scalars
in a parameter block, and a CUDA graph of the frame's launches replayed
once the same launches have been seen twice in a row. There a merged
frame's models keep fixed row ranges (insertion order) and take their rank
from the block; equal keys carry one rank, so the stable sort gives the
entries of the order-laid buffer of `merged_entries`, in its order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.camera import CameraTrait
from ..core.edit import GaussianEditPod, SelectionHighlightPod
from ..core.transform import GaussianDisplayMode, GaussianTransform, ModelTransform
from ..data.compression import Compressions
from ..data.gaussian import Gaussians
from ..ops.binning import TileConfig, build_sorted_entries, enumerate_entries_from_pre
from ..ops.composite import composite_tiles_v2, over_background
from ..ops.fused import enumerate_entries_fused, preprocess_fused
from ..ops.sort import sort_entries
from ..utils import trace
from .buffers import GaussianBuffers
from .graph import FrameGraphs


def render_frame(pod: dict, comp: Compressions, cfg: TileConfig, view, proj, model,
                 size: float = 1.0, sh_degree: int = 3, no_sh0: bool = False,
                 display_mode: int = 0, **gates) -> torch.Tensor:
    """One model through the staged pipeline -> (H, W, 4) premultiplied rgba:
    `preprocess_fused` (K8) -> `build_sorted_entries` (K5, K2) ->
    `composite_tiles_v2` (K3); their plain versions on a CPU pod. `gates` as
    in `preprocess`."""
    pre = preprocess_fused(pod, comp, view, proj, model, cfg.width, cfg.height,
                           sh_degree=sh_degree, no_sh0=no_sh0, size=size,
                           display_mode=display_mode, **gates)
    flat = display_mode != int(GaussianDisplayMode.SPLAT)
    return composite_tiles_v2(build_sorted_entries(pre, cfg), cfg, flat_mode=flat)


class ViewerModel:
    """One model slot: buffers + transform + visibility."""

    def __init__(self, file_name: str, capacity: int, comp: Compressions, device):
        self.file_name = file_name
        self.buffers = GaussianBuffers(capacity, comp, device)
        self.transform = ModelTransform()
        self.visible = True
        self.center = np.zeros(3, np.float32)
        self.gaussians: Optional[Gaussians] = None  # host copy (export path)
        self._placed = (None, None, None)  # (what they were made from, matrix, centre)

    def set_gaussians(self, g: Gaussians) -> None:
        self.gaussians = g
        self.center = g.center()
        self.buffers.upload_all(g)

    def _placement(self) -> tuple:
        """(model matrix, world centre), made again only when the transform
        or the centre changed."""
        t = self.transform
        made_from = tuple(np.asarray(x, np.float32).tobytes()
                          for x in (t.pos, t.rot, t.scale, self.center))
        if made_from != self._placed[0]:
            mat = t.matrix()
            self._placed = (made_from, mat, mat[:3, :3] @ self.center + mat[:3, 3])
        return self._placed[1], self._placed[2]

    def model_matrix(self) -> np.ndarray:
        """The (4, 4) f32 model matrix of the transform."""
        return self._placement()[0]


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
        # Front-end route: K1 from the pod (True) or the preprocess (K8)
        # then K5 (False). Sort and compositor are the same on both.
        fused: bool = True,
    ):
        self.cfg = TileConfig(width, height, tile=tile, max_dup=max_dup)
        self.comp = comp
        self.device = torch.device(device)
        self.fused = fused
        self.models: dict[str, ViewerModel] = {}
        self.gaussian_transform = GaussianTransform()
        self.selection_edit: Optional[GaussianEditPod] = None
        self.highlight = SelectionHighlightPod()
        self.show_highlight = False
        self._background = self.background_tensor = None
        self.background = background
        self._graphs = None  # FrameGraphs: the fused frame on a card, made at its first frame
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

    def add_empty_model(self, key: str, capacity: int) -> ViewerModel:
        """Streaming slot: allocates `capacity`; `buffers.update_range` fills
        it (the model is skipped while nothing is loaded)."""
        key = self.dedup_key(key)
        m = ViewerModel(key, capacity, self.comp, self.device)
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

    def set_compressions(self, comp: Compressions) -> None:
        """Switch the compression of a loaded scene: every model's pod is
        packed again from its host gaussians; edits, selection and mask carry
        over (they do not depend on the compression). A streamed model with
        no host copy loses its splats."""
        if comp == self.comp:
            return
        self.comp = comp
        for m in self.models.values():
            old = m.buffers
            buf = GaussianBuffers(old.capacity, comp, self.device)
            if m.gaussians is not None and m.gaussians.count:
                buf.upload_all(m.gaussians)
            buf.adopt_edit_state(old)
            m.buffers = buf

    # --- world state ----------------------------------------------------------

    @property
    def background(self) -> np.ndarray:
        """The (3,) f32 background colour (set it whole: the frame reads the
        copy on the device)."""
        return self._background

    @background.setter
    def background(self, value) -> None:
        """Set the colour and write it into `background_tensor`, the copy on
        the viewer's device that the frame reads (in place: a captured frame
        graph reads it where it lies)."""
        self._background = np.array(value, np.float32).reshape(3)
        host = torch.from_numpy(self._background.copy())
        if self.background_tensor is None:
            self.background_tensor = host.to(self.device)
        else:
            # From pageable memory: on a card the copy waits for the stream.
            with trace.host_read(self.device.type == "cuda"):
                self.background_tensor.copy_(host)

    def update_camera(self, camera: CameraTrait) -> None:
        self._view = np.asarray(camera.view(), np.float32)
        self._proj = np.asarray(camera.projection(self.cfg.width / self.cfg.height), np.float32)
        self._cam_pos = np.asarray(camera.pos, np.float32)

    def update_model_transform(self, key: str, transform: ModelTransform) -> None:
        self.models[key].transform = transform

    def update_gaussian_transform(self, gt: GaussianTransform) -> None:
        self.gaussian_transform = gt

    def resize(self, width: int, height: int) -> None:
        """Viewport resize; call `update_camera` again for the new aspect."""
        self.cfg = TileConfig(width, height, tile=self.cfg.tile, max_dup=self.cfg.max_dup)

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
            return float(np.linalg.norm(self.models[k]._placement()[1] - self._cam_pos))

        return sorted(keys, key=depth, reverse=True)

    def _model_entries(self, key: str, cfg: TileConfig, rank: int, show_unedited: bool,
                       out=None) -> torch.Tensor:
        """One model's unsorted entries under `cfg` with model rank `rank`,
        by the viewer's front-end route; written into `out` when given."""
        with trace.span("k1.frontend"):
            m = self.models[key]
            gt = self.gaussian_transform
            kw = dict(sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0, size=gt.size,
                      display_mode=int(gt.display_mode), **self._gating_kwargs(m, show_unedited))
            if self.fused:
                return enumerate_entries_fused(m.buffers.pod, self.comp, cfg, self._view,
                                               self._proj, m.model_matrix(), model_rank=rank,
                                               out=out, **kw)
            pre = preprocess_fused(m.buffers.pod, self.comp, self._view, self._proj,
                                   m.model_matrix(), cfg.width, cfg.height, **kw)
            return enumerate_entries_from_pre(pre, cfg, model_rank=rank, out=out)

    def _composite(self, entries: torch.Tensor, cfg: TileConfig) -> torch.Tensor:
        flat = self.gaussian_transform.display_mode != GaussianDisplayMode.SPLAT
        with trace.span("k2.sort"):
            se = sort_entries(entries, cfg)
        with trace.span("k3.composite"):
            return composite_tiles_v2(se, cfg, flat_mode=flat)

    def render_model(self, key: str, show_unedited: bool = False) -> torch.Tensor:
        """One model -> (H, W, 4) premultiplied rgba on the viewer's device.
        `show_unedited` drops the edits (per-splat and selection) but keeps
        the mask and the highlight."""
        return self._composite(self._model_entries(key, self.cfg, 0, show_unedited), self.cfg)

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
        with trace.span("viewer.render"):
            with trace.span("viewer.prologue"):
                if camera is not None:
                    self.update_camera(camera)
                order = self.model_order()
            if not order:
                return self.background_tensor.expand(self.cfg.height, self.cfg.width, 3).clone()
            if self.fused and self.device.type == "cuda":
                if self._graphs is None:
                    self._graphs = FrameGraphs(self)
                return self._graphs.render(order, show_unedited)
            if len(order) > 1:
                return self._render_merged(order, show_unedited)
            return over_background(self.render_model(order[0], show_unedited),
                                   self.background_tensor)

    def merged_config(self, n_models: int) -> TileConfig:
        """The viewer's tiling with a rank field wide enough for `n_models`."""
        return dataclasses.replace(self.cfg, model_bits=max(1, (n_models - 1).bit_length()))

    def merged_entries(self, order: list, show_unedited: bool = False) -> tuple:
        """The unsorted entries of the models in `order` (back to front) in
        one buffer, and the merged config. Model i of the order gets rank
        n - 1 - i (nearest = 0); each front-end launch writes its rows of the
        one buffer, so nothing is concatenated."""
        n = len(order)
        with trace.span("viewer.prologue"):
            cfg_m = self.merged_config(n)
            rows = [self.models[k].buffers.capacity * cfg_m.max_dup for k in order]
            entries = torch.empty((sum(rows), 4), dtype=torch.int32, device=self.device)
        start = 0
        for i, (key, r) in enumerate(zip(order, rows)):
            self._model_entries(key, cfg_m, n - 1 - i, show_unedited, out=entries[start:start + r])
            start += r
        return entries, cfg_m

    def _render_merged(self, order: list, show_unedited: bool) -> torch.Tensor:
        """Several models in one pass: one entry buffer, one sort, one
        composite."""
        entries, cfg_m = self.merged_entries(order, show_unedited)
        return over_background(self._composite(entries, cfg_m), self.background_tensor)


class Viewer(MultiModelViewer):
    """Single-model convenience viewer."""

    def __init__(self, g: Gaussians, width: int, height: int, **kw):
        super().__init__(width, height, **kw)
        self.add_model("model", g)
