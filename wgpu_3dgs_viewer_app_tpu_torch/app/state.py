"""The app session: loading, the scene command bus, masks, selection,
measurement and the frame with its overlays, in one host-side object.

Counterpart of `wgpu_3dgs_viewer_app_tpu.app.state`. A frame (`update`)
drains the streaming loader, then the scene commands (add / remove a model,
update a measurement hit, evaluate the mask), applies the selection queries
of the frame, renders through the viewer and draws the overlays in the
reference's paint order: mask gizmos, measurement lines, the selection
texture and the brush cursor.

Where the JAX session picks its kernels with `use_pallas`, this one takes a
`device`: on a CUDA device every frame runs the front-end K1 (gated by the
mask bits and the edits once they exist), the entry sort K2 and the
compositor K3, then the overlays as one launch of K9, and the selection
and hit queries run the query-geometry kernel K4; on the CPU (only when
asked for) their plain versions run. The
mask is evaluated on the device too: the model's host positions are
uploaded for each evaluation.
"""

from __future__ import annotations

import dataclasses
import enum
import queue
import time
from typing import BinaryIO, Optional

import numpy as np
import torch

from ..core.camera import Camera, CameraOrbitControl
from ..core.edit import (EDIT_FLAG_ENABLED, EDIT_FLAG_HIDDEN, EDIT_FLAG_OVERRIDE_COLOR,
                         GaussianEditPod, SelectionHighlightPod)
from ..core.transform import GaussianTransform
from ..data.compression import Compressions
from ..data.gaussian import Gaussians
from ..mask.evaluate import MaskEvaluator
from ..mask.expr import MaskOp, parse
from ..mask.gizmo import gizmo_lines
from ..mask.shapes import MaskShape
from ..ops.fused import preprocess_geometry_fused
from ..ops.overlay import draw_overlays
from ..query.hit import query_hit
from ..query.pods import QuerySelectionOp
from ..query.selection import (QueryToolset, apply_query_pod, combine_selection,
                               sample_texture_at_centers)
from ..utils import trace
from ..utils.log import get_logger
from ..viewer.viewer import MultiModelViewer
from .loader import StreamingLoader
from .measurement import Measurement, MeasurementHitPair, measurement_lines

_LOG = get_logger("state")


class Action(enum.Enum):
    """Current viewport action (camera or a query tool)."""

    NONE = "none"
    SELECTION = "selection"
    MEASUREMENT_LOCATE_HIT = "measurement_locate_hit"


class SelectionMethod(enum.Enum):
    RECT = "rect"
    BRUSH = "brush"


@dataclasses.dataclass
class Selection:
    method: SelectionMethod = SelectionMethod.RECT
    operation: QuerySelectionOp = QuerySelectionOp.SET
    immediate: bool = False
    brush_radius: int = 40
    highlight_color: tuple = (1.0, 0.0, 1.0, 127 / 255)
    edit: Optional["SelectionEdit"] = None
    show_unedited: bool = False


@dataclasses.dataclass
class SelectionEdit:
    """The live selection edit; `to_pod` gives the front-end's record."""

    hidden: bool = False
    hsv: Optional[tuple] = (0.0, 1.0, 1.0)
    override_rgb: Optional[tuple] = None
    contrast: float = 0.0
    exposure: float = 0.0
    gamma: float = 1.0
    alpha: float = 1.0

    def to_pod(self) -> GaussianEditPod:
        flags = EDIT_FLAG_ENABLED
        color = self.hsv if self.override_rgb is None else self.override_rgb
        if self.hidden:
            flags |= EDIT_FLAG_HIDDEN
        if self.override_rgb is not None:
            flags |= EDIT_FLAG_OVERRIDE_COLOR
        return GaussianEditPod(flags=flags, rgb_or_hsv=tuple(color), contrast=self.contrast,
                               exposure=self.exposure, gamma=self.gamma, alpha=self.alpha)


@dataclasses.dataclass
class MaskState:
    """The mask shapes and the op code over their indices."""

    shapes: list = dataclasses.field(default_factory=list)
    op_code: str = ""

    def add_shape(self, shape: Optional[MaskShape] = None) -> MaskShape:
        s = shape or MaskShape()
        self.shapes.append(s)
        return s

    def parse_op(self) -> Optional[MaskOp]:
        op = parse(self.op_code)
        if op is not None:
            op.validate_shapes(len(self.shapes))
        return op


class SceneCommandKind(enum.Enum):
    ADD_MODEL = "add_model"
    REMOVE_MODEL = "remove_model"
    UPDATE_MEASUREMENT_HIT = "update_measurement_hit"
    EVALUATE_MASK = "evaluate_mask"


@dataclasses.dataclass
class SceneCommand:
    kind: SceneCommandKind
    file_name: Optional[str] = None
    reader: Optional[BinaryIO] = None
    key: Optional[str] = None
    mask_op: Optional[MaskOp] = None


class FpsCounter:
    """Frames per second, refreshed once a second."""

    def __init__(self):
        self._last = time.monotonic()
        self._frames = 0
        self.fps = 0.0

    def tick(self) -> float:
        self._frames += 1
        now = time.monotonic()
        dt = now - self._last
        if dt >= 1.0:
            self.fps = self._frames / dt
            self._frames = 0
            self._last = now
        return self.fps


class GaussianSplattingSession:
    """The root interactive session: camera, models, loader, commands,
    selection, mask and measurement state, and the frame."""

    def __init__(self, width: int = 1280, height: int = 720,
                 compressions: Compressions = Compressions(), device="cuda", tile: int = 32,
                 max_dup: int = 4):
        self.device = torch.device(device)
        self.camera = Camera.default()
        self.compressions = compressions
        self.viewer = MultiModelViewer(width, height, comp=compressions, tile=tile,
                                       max_dup=max_dup, device=self.device)
        self.selected_key: Optional[str] = None
        self.gaussian_transform = GaussianTransform()
        self.action = Action.NONE
        self.measurement = Measurement()
        self.selection = Selection()
        self.mask = MaskState()
        self.toolset = QueryToolset(width, height, device=self.device)
        self.scene_q: "queue.Queue[SceneCommand]" = queue.Queue()
        self.loader: Optional[tuple] = None  # (key, StreamingLoader)
        self._load_host: Optional[Gaussians] = None  # host copy being filled
        self.fps = FpsCounter()
        self.mask_evaluator = MaskEvaluator(self.device)
        self.theme = "dark"
        # _auto_frame only moves a camera still at this as-constructed pose.
        self._camera_initial_pose = self._camera_pose()

    def _camera_pose(self):
        ctl = self.camera.control
        if hasattr(ctl, "target"):
            return (np.array(ctl.target, np.float32), np.array(ctl.pos, np.float32))
        return (np.array(ctl.pos, np.float32),)

    # --- model loading ----------------------------------------------------------

    def open_model(self, file_name: str, reader: BinaryIO) -> None:
        """Start a streamed load; refused while another load runs."""
        if self.loader is not None:
            raise RuntimeError("another model is still loading")
        loader = StreamingLoader(reader)
        key = self.viewer.dedup_key(file_name)
        _LOG.info("streaming load %r: %d splats", key, loader.count)
        self.viewer.add_empty_model(key, loader.count)
        if self.selected_key is None:
            self.selected_key = key
        self._load_host = Gaussians.empty(loader.count)
        self.loader = (key, loader)

    def send_command(self, cmd: SceneCommand) -> None:
        self.scene_q.put(cmd)

    def set_compressions(self, comp: Compressions) -> None:
        """Change the compression of the live scene, packing the loaded models
        again."""
        if self.loader is not None:
            raise RuntimeError("cannot change compression while a model is loading")
        self.compressions = comp
        _LOG.info("re-packing loaded models to %s", comp)
        self.viewer.set_compressions(comp)

    def _drain_loader(self) -> None:
        """Upload what the loader has parsed within one frame's budget. The
        drained chunks go to the device in one `update_range` (the pack is
        per splat, so this equals one upload per chunk) and into the
        preallocated host copy, of which `model.gaussians` is the loaded
        prefix."""
        if self.loader is None:
            return
        key, loader = self.loader
        model = self.viewer.models.get(key)
        if model is None:
            self.loader = None
            return
        with trace.span("loader.drain"):
            start = loader.received
            chunks = []
            loader.drain(on_chunk=lambda _, chunk: chunks.append(chunk))
            if chunks:
                g = chunks[0] if len(chunks) == 1 else Gaussians.concat(chunks)
                model.buffers.update_range(start, g)
                host = self._load_host
                for f in dataclasses.fields(Gaussians):
                    getattr(host, f.name)[start:start + g.count] = getattr(g, f.name)
                model.gaussians = host.slice(0, loader.received)
                model.center = model.gaussians.center()
            if loader.finished:
                self.loader = None
                self._load_host = None
                self._auto_frame(model)

    def _auto_frame(self, model) -> None:
        """Frame the default orbit camera on the first fully loaded model
        (its default 1-unit arm sits inside typical scenes). Only a camera
        still at its as-constructed pose moves."""
        ctl = self.camera.control
        if not isinstance(ctl, CameraOrbitControl):
            return
        pose = self._camera_pose()
        if len(pose) != len(self._camera_initial_pose) or not all(
                np.allclose(a, b) for a, b in zip(pose, self._camera_initial_pose)):
            return
        if model.gaussians is None or len(model.gaussians) == 0:
            return
        center = model.center
        radius = float(np.quantile(np.linalg.norm(model.gaussians.pos - center[None, :], axis=1),
                                   0.95))
        arm = max(2.0 * radius, 0.5)
        ctl.target = np.asarray(center, np.float32)
        ctl.pos = np.asarray(center + np.array([0.0, 0.0, -arm]), np.float32)

    def _drain_commands(self) -> None:
        while True:
            try:
                cmd = self.scene_q.get_nowait()
            except queue.Empty:
                return
            if cmd.kind == SceneCommandKind.ADD_MODEL:
                self.open_model(cmd.file_name, cmd.reader)
            elif cmd.kind == SceneCommandKind.REMOVE_MODEL:
                self.viewer.remove_model(cmd.key)
                if self.selected_key == cmd.key:
                    self.selected_key = next(iter(self.viewer.models), None)
            elif cmd.kind == SceneCommandKind.EVALUATE_MASK:
                self.evaluate_mask(cmd.mask_op)

    # --- mask -------------------------------------------------------------------

    def evaluate_mask(self, op: Optional[MaskOp]) -> None:
        """Evaluate the op tree (None: Reset) over every loaded model on the
        session's device; the bits gate the frame and the queries."""
        cuda = self.device.type == "cuda"
        with trace.span("session.evaluate_mask"):
            pods = [s.to_pod() for s in self.mask.shapes]
            for model in self.viewer.models.values():
                if model.gaussians is None:
                    continue
                host = np.ascontiguousarray(model.gaussians.pos)
                # From pageable memory: on a card the copy waits for the stream.
                with trace.span("mask.upload"), trace.host_read(cuda):
                    pos = torch.from_numpy(host).to(self.device)
                bits = self.mask_evaluator.evaluate(op, pods, (pos[:, 0], pos[:, 1], pos[:, 2]),
                                                    model.transform)
                model.buffers.set_mask(bits)

    # --- selection and queries --------------------------------------------------

    def _selected_model(self):
        if self.selected_key is None:
            return None
        return self.viewer.models.get(self.selected_key)

    def _preprocess_selected(self):
        """The selected model's query geometry at the current camera: K4 on
        the card (its plain version, the degree-0 preprocess, on the CPU),
        gated by the mask and the per-splat edits where they exist."""
        m = self._selected_model()
        if m is None or len(m.buffers) == 0:
            return None
        with trace.span("query.geometry"):
            self.viewer.update_camera(self.camera.control)
            gt = self.gaussian_transform
            b = m.buffers
            edit = (b.edit_flags, b.edit_rgb, b.edit_params) if b.edit_flags is not None else None
            return preprocess_geometry_fused(b.pod, self.compressions, self.viewer._view,
                                             self.viewer._proj, m.transform.matrix(),
                                             self.viewer.cfg.width, self.viewer.cfg.height,
                                             size=gt.size, display_mode=int(gt.display_mode),
                                             mask_bits=b.mask, edit=edit)

    @staticmethod
    def _selection_bits(m) -> torch.Tensor:
        b = m.buffers
        if b.selection is not None:
            return b.selection
        return torch.zeros(b.capacity, dtype=torch.uint8, device=b.device)

    def apply_selection_queries(self) -> None:
        """Apply the toolset's immediate-mode query pods to the selection."""
        m = self._selected_model()
        if m is None:
            return
        pods = self.toolset.query()
        if not pods:
            return
        pre = self._preprocess_selected()
        if pre is None:
            return
        with trace.span("query.region"):
            bits = self._selection_bits(m)
            for pod in pods:
                bits = apply_query_pod(pre, bits, pod)
            m.buffers.set_selection(bits)

    def end_selection_gesture(self) -> None:
        """End the gesture; in texture mode resolve the painted texture."""
        result = self.toolset.end()
        self.apply_selection_queries()
        if result is None:
            return
        op, texture = result
        with trace.span("query.resolve"):
            m = self._selected_model()
            pre = self._preprocess_selected()
            if m is None or pre is None:
                return
            new_bits = sample_texture_at_centers(pre, texture)
            m.buffers.set_selection(combine_selection(self._selection_bits(m), new_bits, op))

    def locate_hit(self, pixel, pair_idx: int, hit_idx: int) -> bool:
        """Hit query at `pixel` -> the world position of hit `hit_idx` of
        measurement pair `pair_idx` (pairs are added as needed)."""
        pre = self._preprocess_selected()
        if pre is None:
            return False
        found, pos = query_hit(pre, np.asarray(pixel, np.float32), self.viewer._view,
                               self.viewer._proj, self.viewer.cfg.width,
                               self.viewer.cfg.height, method=self.measurement.hit_method)
        if not bool(found):
            return False
        while len(self.measurement.hit_pairs) <= pair_idx:
            self.measurement.hit_pairs.append(
                MeasurementHitPair(label=f"Pair {len(self.measurement.hit_pairs)}"))
        self.measurement.hit_pairs[pair_idx].hits[hit_idx].pos = pos.cpu().numpy()
        return True

    def commit_selection_edit(self) -> None:
        """Bake the live selection edit into the per-splat edit records."""
        if self.selection.edit is None:
            return
        f, rgb, params = self.selection.edit.to_pod().as_arrays()
        for m in self.viewer.models.values():
            m.buffers.commit_selection_edit(int(f), rgb, params)

    # --- the frame --------------------------------------------------------------

    def render_overlays(self, img: torch.Tensor) -> torch.Tensor:
        """The overlays over a rendered frame, in the reference's paint order:
        mask gizmos, measurement lines, selection texture, brush cursor. The
        gizmos' and the measurement's segments are one list, gizmos first
        (the image of the two passes). On a CUDA frame all of it is one K9
        launch (`ops.draw_overlays`)."""
        view, proj = self.viewer._view, self.viewer._proj
        h, w = img.shape[:2]
        with trace.span("overlays.segments"):
            parts = [p for p in (gizmo_lines(self.mask.shapes, view, proj, w, h),
                                 measurement_lines(self.measurement, view, proj, w, h))
                     if p is not None]
            lines = tuple(np.concatenate(f) for f in zip(*parts)) if parts else None
        texture = cursor = None
        if self.toolset.state() is not None and self.toolset.use_texture:
            texture = self.toolset.texture
        if (self.action == Action.SELECTION and self.selection.method == SelectionMethod.BRUSH
                and self.toolset._last_pos is not None):
            cursor = (np.asarray(self.toolset._last_pos, np.float32),
                      float(self.selection.brush_radius))
        return draw_overlays(img, lines, texture, cursor)

    def update(self) -> torch.Tensor:
        """One frame: drain the loader and the commands, apply the queries,
        render, draw the overlays -> (H, W, 3) f32 on the session's device."""
        with trace.span("session.update"):
            with trace.span("session.drain"):
                self._drain_loader()
                self._drain_commands()
            with trace.span("session.queries"):
                self.apply_selection_queries()
            self.viewer.update_gaussian_transform(self.gaussian_transform)
            edit = self.selection.edit
            self.viewer.update_selection_edit(edit.to_pod() if edit is not None else None)
            self.viewer.update_selection_highlight(
                SelectionHighlightPod(rgba=self.selection.highlight_color),
                show=self.action == Action.SELECTION)
            img = self.viewer.render(self.camera.control,
                                     show_unedited=self.selection.show_unedited)
            with trace.span("session.overlays"):
                img = self.render_overlays(img)
            self.fps.tick()
            return img
