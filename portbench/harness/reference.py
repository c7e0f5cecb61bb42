"""The plain reference's frame, from the benchmark's own inputs.

`Reference` packs the scene itself (the frozen numpy codec of `gsref`),
orders the models as the viewer does, and runs the frozen plain pipeline:
preprocess -> enumerate and pack -> stable sort -> compositor, one merged
pass with a model rank in the key where several models are visible. Gates
(mask, selection, edits, highlight) and the gizmo overlays are worked out
again from the state the traffic set, never read from the port. `dtype`
is the precision of the arithmetic (float32, or lower for the control)."""

from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from .spec import HERE

if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

from gsref.core.camera import CameraOrbitControl  # noqa: E402
from gsref.core.edit import (EDIT_FLAG_ENABLED, EDIT_FLAG_HIDDEN,  # noqa: E402
                             EDIT_FLAG_OVERRIDE_COLOR)
from gsref.core.transform import ModelTransform  # noqa: E402
from gsref.data.compression import (Compressions, Cov3dCompression,  # noqa: E402
                                    ShCompression, flat_pod_to_words, pack_gaussians)
from gsref.data.gaussian import Gaussians  # noqa: E402
from gsref.mask.evaluate import MaskEvaluator  # noqa: E402
from gsref.mask.expr import parse  # noqa: E402
from gsref.mask.gizmo import gizmo_lines  # noqa: E402
from gsref.mask.shapes import MaskShape, MaskShapeKind  # noqa: E402
from gsref.ops.binning import TileConfig, enumerate_entries_from_pre_plain  # noqa: E402
from gsref.ops.composite import composite_tiles_plain_v2, over_background  # noqa: E402
from gsref.ops.overlay import draw_overlays  # noqa: E402
from gsref.ops.preprocess import preprocess  # noqa: E402
from gsref.ops.sort import sort_entries_plain  # noqa: E402
from gsref.query.selection import select_rect  # noqa: E402


DISPLAY_MODES = {"splat": 0, "ellipse": 1, "point": 2}


def display_mode(config: dict) -> int:
    """The configuration's display mode (splat, ellipse or point) as the
    preprocess's code; any other is refused."""
    mode = config.get("display_mode", "splat")
    if mode not in DISPLAY_MODES:
        raise ValueError(f"display_mode {mode!r} is none of {sorted(DISPLAY_MODES)}")
    return DISPLAY_MODES[mode]


def sh_degree(config: dict) -> int:
    deg = int(config.get("sh_degree", 3))
    if not 0 <= deg <= 3:
        raise ValueError(f"sh_degree {deg} is not in 0..3")
    return deg


def compressions(config: dict) -> Compressions:
    c = config["compressions"]
    return Compressions(sh=ShCompression(c["sh"]), cov3d=Cov3dCompression(c["cov3d"]))


def model_transform(m: dict) -> ModelTransform:
    return ModelTransform(pos=np.asarray(m.get("pos", (0, 0, 0)), np.float32),
                          rot=np.asarray(m.get("rot_deg", (0, 0, 0)), np.float32))


def model_edit(m: dict, n: int):
    """The configuration's per-splat edit of a model: (flags, rgb, params)
    with every splat enabled, or None."""
    e = m.get("edit")
    if e is None:
        return None
    flags = np.full(n, EDIT_FLAG_ENABLED, np.int32)
    rgb = np.tile(np.asarray(e["hsv"], np.float32), (n, 1))
    params = np.tile(np.asarray([0.0, 0.0, 1.0, 1.0], np.float32), (n, 1))
    return flags, rgb, params


def camera_at(config: dict, yaw: float, pitch: float | None = None) -> CameraOrbitControl:
    """The configuration's orbit camera at `yaw` (radians) around its
    target; `pitch` defaults to the configuration's elevation."""
    cam = config["camera"]
    r = float(cam["radius"])
    pitch = math.radians(float(cam["pitch_deg"])) if pitch is None else pitch
    t = np.asarray(cam["target"], np.float32)
    eye = t + r * np.array([math.cos(pitch) * math.sin(yaw), math.sin(pitch),
                            math.cos(pitch) * math.cos(yaw)], np.float32)
    return CameraOrbitControl(target=t, pos=eye, z=(0.1, 1e4),
                              vertical_fov=math.radians(float(cam.get("fov_deg", 60.0))))


def placed_shapes(config: dict, traffic: dict) -> list:
    """The mix's mask shapes (kind, pos, scale), placed in units of the
    scene's scale about the camera's target."""
    scale = float(config["scene"]["models"][0]["scene_scale"])
    center = np.asarray(config["camera"]["target"], np.float32)
    return [dict(kind=s["kind"], pos=center + scale * np.asarray(s["at"], np.float32),
                 scale=np.full(3, scale * s["size"], np.float32))
            for s in traffic["mask"]["shapes"]]


def mask_shapes(spec: list) -> list:
    return [MaskShape(kind=MaskShapeKind(s["kind"]), pos=np.asarray(s["pos"], np.float32),
                      rot=np.asarray(s.get("rot", (0, 0, 0)), np.float32),
                      scale=np.asarray(s["scale"], np.float32)) for s in spec]


def selection_edit_arrays(e: dict):
    """The session's SelectionEdit record (flags, rgb or hsv, params)."""
    flags = EDIT_FLAG_ENABLED
    color = e.get("hsv", (0.0, 1.0, 1.0))
    if e.get("hidden"):
        flags |= EDIT_FLAG_HIDDEN
    if e.get("override_rgb") is not None:
        flags |= EDIT_FLAG_OVERRIDE_COLOR
        color = e["override_rgb"]
    params = [e.get("contrast", 0.0), e.get("exposure", 0.0), e.get("gamma", 1.0),
              e.get("alpha", 1.0)]
    return np.uint32(flags), np.asarray(color, np.float32), np.asarray(params, np.float32)


@dataclasses.dataclass
class RefModel:
    pod: dict
    count: int
    pos: torch.Tensor          # (N, 3) host-order positions on the device
    center: np.ndarray
    transform: ModelTransform
    edit: tuple | None


class Reference:
    def __init__(self, config: dict, models: list, device, dtype=torch.float32):
        """`models`: the scene's models as Gaussians field arrays (numpy)."""
        self.config = config
        self.device = torch.device(device)
        self.dtype = dtype
        self.comp = compressions(config)
        w, h = config["width"], config["height"]
        self.cfg = TileConfig(w, h, tile=config["tile"], max_dup=config["max_dup"])
        self.background = np.asarray(config.get("background", (0.0, 0.0, 0.0)), np.float32)
        self.mode = display_mode(config)
        self.sh_degree = sh_degree(config)
        self.models = []
        for spec, arrays in zip(config["scene"]["models"], models):
            g = Gaussians(**arrays)
            words = flat_pod_to_words(pack_gaussians(g, self.comp), self.comp)
            pod = {k: torch.from_numpy(np.ascontiguousarray(v).view(np.int32)
                                       if v.dtype == np.uint32
                                       else np.ascontiguousarray(v, np.float32)).to(self.device)
                   for k, v in words.items()}
            edit = model_edit(spec, g.count)
            if edit is not None:
                edit = tuple(torch.from_numpy(x).to(self.device) for x in edit)
            self.models.append(RefModel(pod=pod, count=g.count,
                                        pos=torch.from_numpy(g.pos).to(self.device),
                                        center=g.center(), transform=model_transform(spec),
                                        edit=edit))

    def order(self, cam_pos) -> list:
        """Model indices back to front by the distance of their centres."""
        def depth(i):
            m = self.models[i]
            mat = m.transform.matrix()
            c = mat[:3, :3] @ m.center + mat[:3, 3]
            return float(np.linalg.norm(c - np.asarray(cam_pos, np.float32)))

        return sorted(range(len(self.models)), key=depth, reverse=True)

    def mask_bits(self, op_code: str, shapes: list, i: int = 0) -> torch.Tensor:
        op = parse(op_code)
        m = self.models[i]
        return MaskEvaluator(self.device).evaluate(op, [s.to_pod() for s in shapes],
                                                   m.pos.unbind(1), m.transform)

    def selection_bits(self, camera, rect, mask=None, i: int = 0) -> torch.Tensor:
        """The rect selection (SET) of model i at `camera`: centres of the
        degree-0 preprocess inside the rect, gated by the mask."""
        m = self.models[i]
        view = camera.view()
        proj = camera.projection(self.cfg.width / self.cfg.height)
        pre = preprocess(m.pod, self.comp, view, proj, m.transform.matrix(), self.cfg.width,
                         self.cfg.height, sh_degree=0, display_mode=self.mode, mask_bits=mask,
                         edit=m.edit, dtype=self.dtype)
        return select_rect(pre, rect[0], rect[1])

    def frame(self, camera, gates: list | None = None, shapes: list | None = None,
              stats: dict | None = None) -> torch.Tensor:
        """(H, W, 3) f32 frame at `camera`; `gates[i]` the gate keywords of
        model i (mask_bits, selection_bits, selection_edit,
        highlight_rgba), `shapes` the mask shapes whose gizmos are drawn.
        With `stats`, fills splats, live_entries, blends, entries_read."""
        cfg = self.cfg
        view = camera.view()
        proj = camera.projection(cfg.width / cfg.height)
        order = self.order(camera.pos)
        n = len(order)
        if n > 1:
            cfg = dataclasses.replace(cfg, model_bits=max(1, (n - 1).bit_length()))
        entries = []
        for k, i in enumerate(order):
            m = self.models[i]
            kw = dict(gates[i]) if gates else {}
            if m.edit is not None:
                kw["edit"] = m.edit
            pre = preprocess(m.pod, self.comp, view, proj, m.transform.matrix(), cfg.width,
                             cfg.height, sh_degree=self.sh_degree, display_mode=self.mode,
                             dtype=self.dtype, **kw)
            entries.append(enumerate_entries_from_pre_plain(pre, cfg, n - 1 - k if n > 1 else 0))
            del pre
        se = sort_entries_plain(torch.cat(entries) if n > 1 else entries[0], cfg)
        del entries
        st = {} if stats is not None else None
        img = over_background(composite_tiles_plain_v2(se, cfg, flat_mode=self.mode != 0,
                                                       stats=st, dtype=self.dtype),
                              self.background)
        if stats is not None:
            stats.update(splats=sum(m.count for m in self.models), live_entries=se.n_valid,
                         blends=st["pairs"], entries_read=st["entries"], n_tiles=cfg.n_tiles,
                         pixels=cfg.width * cfg.height)
        if shapes:
            lines = gizmo_lines(shapes, view, proj, cfg.width, cfg.height)
            img = draw_overlays(img, lines)
        return img
