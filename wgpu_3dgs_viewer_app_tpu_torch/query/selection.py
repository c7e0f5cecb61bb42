"""Selection: rect and brush queries with Set/Add/Remove, in immediate and
texture mode. Counterpart of `wgpu_3dgs_viewer_app_tpu.query.selection`.

A splat is selected when its projected centre falls inside the region and
it survives the preprocess (`PreprocessOut.valid`). Selection state is
(N,) uint8 bits on the device of the `PreprocessOut`. Region tests run in
f32 with the region's corners rounded to f32 on the host, as the reference
does; the query texture is a (H, W) bool tensor painted in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.preprocess import PreprocessOut, host_array
from ..utils import trace
from .pods import QueryBrushPod, QueryRectPod, QuerySelectionOp


def _f32(v) -> np.ndarray:
    return host_array(v).astype(np.float32).reshape(-1)


def combine_selection(old_bits, new_bits, op: QuerySelectionOp) -> torch.Tensor:
    """Apply a selection op to (N,) bits -> (N,) uint8."""
    old_b = torch.as_tensor(old_bits) != 0
    new_b = torch.as_tensor(new_bits, device=old_b.device) != 0
    if op == QuerySelectionOp.SET:
        out = new_b
    elif op == QuerySelectionOp.ADD:
        out = old_b | new_b
    else:
        out = old_b & ~new_b
    return out.to(torch.uint8)


def _rect(top_left, bottom_right) -> tuple:
    a, b = _f32(top_left), _f32(bottom_right)
    return np.minimum(a, b).tolist(), np.maximum(a, b).tolist()


def select_rect(pre: PreprocessOut, top_left, bottom_right) -> torch.Tensor:
    """Splat centres inside the pixel rect -> (N,) uint8."""
    tl, br = _rect(top_left, bottom_right)
    inside = ((pre.mean_x >= tl[0]) & (pre.mean_x <= br[0])
              & (pre.mean_y >= tl[1]) & (pre.mean_y <= br[1]))
    return (inside & pre.valid).to(torch.uint8)


def _segment_dist2(x, y, a, b):
    """Squared distance of points (x, y) to the segment a -> b (f32)."""
    ab = b - a
    denom = max(np.float32(ab[0] * ab[0]) + np.float32(ab[1] * ab[1]), np.float32(1e-12))
    ax, ay, abx, aby = (float(v) for v in (a[0], a[1], ab[0], ab[1]))
    t = torch.clamp(((x - ax) * abx + (y - ay) * aby) / float(denom), 0.0, 1.0)
    dx = x - (ax + t * abx)
    dy = y - (ay + t * aby)
    return dx * dx + dy * dy


def select_brush_segment(pre: PreprocessOut, seg_start, seg_end, radius) -> torch.Tensor:
    """Splat centres within `radius` px of the stroke segment -> (N,) uint8."""
    r = np.float32(radius)
    dist2 = _segment_dist2(pre.mean_x, pre.mean_y, _f32(seg_start), _f32(seg_end))
    return ((dist2 <= float(r * r)) & pre.valid).to(torch.uint8)


def _pixel_centres(tex: torch.Tensor) -> tuple:
    h, w = tex.shape
    ys = torch.arange(h, dtype=torch.float32, device=tex.device)[:, None] + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=tex.device)[None, :] + 0.5
    return xs, ys


def _paint_rect(tex: torch.Tensor, top_left, bottom_right) -> torch.Tensor:
    """OR the pixels whose centres lie in the rect into `tex`, in place."""
    xs, ys = _pixel_centres(tex)
    tl, br = _rect(top_left, bottom_right)
    tex |= (xs >= tl[0]) & (xs <= br[0]) & (ys >= tl[1]) & (ys <= br[1])
    return tex


def _paint_segment(tex: torch.Tensor, a, b, radius) -> torch.Tensor:
    """OR the pixels within `radius` of the segment a -> b into `tex`, in place."""
    xs, ys = _pixel_centres(tex)
    xs, ys = torch.broadcast_tensors(xs, ys)
    r = np.float32(radius)
    tex |= _segment_dist2(xs, ys, _f32(a), _f32(b)) <= float(r * r)
    return tex


def sample_texture_at_centers(pre: PreprocessOut, tex: torch.Tensor) -> torch.Tensor:
    """Texture-mode resolve: the query texture at the projected centres ->
    (N,) uint8."""
    h, w = tex.shape
    # Clamp in f32 first so the integer cast never overflows.
    xi = pre.mean_x.clamp(-1.0, float(w)).to(torch.int64).clamp(0, w - 1)
    yi = pre.mean_y.clamp(-1.0, float(h)).to(torch.int64).clamp(0, h - 1)
    on_screen = ((pre.mean_x >= 0) & (pre.mean_x < w) & (pre.mean_y >= 0) & (pre.mean_y < h))
    return (tex[yi, xi] & on_screen & pre.valid).to(torch.uint8)


class QueryToolset:
    """Stateful rect/brush tool: `start(tool, op, pos)` / `update_pos` /
    `end` / `query`.

    In texture mode (`use_texture=True`) strokes paint a (H, W) bool query
    texture on `device`, and the selection resolves on `end()`. In immediate
    mode each `update_pos` emits a query pod to apply this frame.
    """

    RECT = "rect"
    BRUSH = "brush"

    def __init__(self, width: int, height: int, device="cuda"):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.use_texture = False
        self.brush_radius = 40.0
        self.texture = self._blank()
        self._active = None  # (tool, op)
        self._start_pos = None
        self._last_pos = None
        self._op_emitted = False
        self._pending: list = []

    def _blank(self) -> torch.Tensor:
        return torch.zeros((self.height, self.width), dtype=torch.bool, device=self.device)

    def set_use_texture(self, value: bool) -> None:
        self.use_texture = value

    def update_brush_radius(self, r: float) -> None:
        self.brush_radius = float(r)

    def state(self):
        return self._active

    def start(self, tool: str, op: QuerySelectionOp, pos) -> None:
        self._active = (tool, op)
        self._start_pos = np.asarray(pos, np.float32)
        self._last_pos = self._start_pos
        self._op_emitted = False
        self.texture = self._blank()
        if tool == self.BRUSH:
            self._stroke(self._start_pos, self._start_pos)

    def update_pos(self, pos) -> None:
        if self._active is None:
            return
        pos = np.asarray(pos, np.float32)
        tool, op = self._active
        if tool == self.BRUSH:
            self._stroke(self._last_pos, pos)
        else:
            with trace.span("query.paint"):
                self.texture = _paint_rect(self._blank(), self._start_pos, pos)
            if not self.use_texture:
                self._pending = [QueryRectPod(tuple(self._start_pos), tuple(pos), op)]
        self._last_pos = pos

    def _stroke(self, a, b) -> None:
        _, op = self._active
        with trace.span("query.paint"):
            _paint_segment(self.texture, a, b, self.brush_radius)
        if not self.use_texture:
            # Within one gesture only the first stroke carries the gesture
            # op; later strokes extend it (a SET drag keeps its own path).
            eff = op
            if self._op_emitted and op == QuerySelectionOp.SET:
                eff = QuerySelectionOp.ADD
            self._op_emitted = True
            self._pending.append(QueryBrushPod(tuple(a), tuple(b), self.brush_radius, eff))

    def end(self):
        """Finish the gesture. Returns (op, texture) for the texture-mode
        resolve, or None in immediate mode (the pods were emitted)."""
        if self._active is None:
            return None
        tool, op = self._active
        self._active = None
        if self.use_texture:
            return op, self.texture
        if tool == self.RECT:
            self._pending = [QueryRectPod(tuple(self._start_pos), tuple(self._last_pos), op)]
        return None

    def query(self):
        """Drain the immediate-mode query pods of this frame."""
        pods, self._pending = self._pending, []
        return pods


def apply_query_pod(pre: PreprocessOut, bits, pod):
    """Evaluate one immediate-mode query pod against the preprocess outputs."""
    if isinstance(pod, QueryRectPod):
        new = select_rect(pre, pod.top_left, pod.bottom_right)
    elif isinstance(pod, QueryBrushPod):
        new = select_brush_segment(pre, pod.start, pod.end, pod.radius)
    else:
        return bits
    return combine_selection(bits, new, pod.op)
