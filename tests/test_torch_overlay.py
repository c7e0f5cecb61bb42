"""The app frame's overlays, kernel K9's stages, on the CPU: the session's
`render_overlays` (gizmos, a measurement pair, the selection texture and
the brush ring) against the JAX functions called in the reference's paint
order (`wgpu_3dgs_viewer_app_tpu/app/state.py:474-497`) within 1e-5;
`segment_table`; `rasterize_lines_plain` bit for bit the port's image
before K9; K9's algorithm written out in numpy in the kernel's order
(`_k9`: tile lists, f64 fma steps, blends) bit for bit the plain versions,
alone and as a stand-in library behind `ops.overlay_cuda`, so that the
wrapper's packing is held too; and that the CPU entry points launch nothing
and need no nvcc. Inputs are made by numpy from a seed and handed to both."""

import ctypes
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu import app as japp
from wgpu_3dgs_viewer_app_tpu import mask as jmask
from wgpu_3dgs_viewer_app_tpu import query as jquery
from wgpu_3dgs_viewer_app_tpu_torch import app, convert
from wgpu_3dgs_viewer_app_tpu_torch.core import lines
from wgpu_3dgs_viewer_app_tpu_torch.ops import draw_overlays, kernels, overlay_cuda
from wgpu_3dgs_viewer_app_tpu_torch.query import (QuerySelectionOp, QueryToolset,
                                                  overlay_cursor_ring, overlay_texture)
from wgpu_3dgs_viewer_app_tpu_torch.query.overlay import (CURSOR_RGBA, TEXTURE_RGBA,
                                                          overlay_cursor_ring_plain,
                                                          overlay_texture_plain)

# The port against the JAX package (tests/test_torch_mask.py's tolerance):
# the port repeats the reference's fma contractions and dot order.
LINE_TOL = 1e-5
H, W = 120, 160
BRUSH = ((30.0, 40.0), (110.0, 70.0))
# The images `rasterize_lines` made before K9 (the plain version then was
# the whole function) on `_rasterize_data(seed)`: digests of their bytes.
PARENT_DIGESTS = {0: "a97410278e9a78a23c59b9b661396932ee3bda06658a4d26d033b86afaa0cbcb",
                  1: "01eea2f49e84343729740148d23aa903470266a367dce25ad3d484d931b12a03"}


def _jax_shapes():
    J = jmask.MaskShapeKind
    return [jmask.MaskShape(kind=J.BOX, pos=np.array([0.1, -0.1, 0.0], np.float32),
                            rot=np.array([10, 35, -20], np.float32),
                            scale=np.array([1.5, 1.0, 1.2], np.float32)),
            jmask.MaskShape(kind=J.ELLIPSOID, pos=np.array([0.4, 0.0, 0.0], np.float32),
                            rot=np.array([0, 30, 20], np.float32),
                            scale=np.array([0.9, 1.2, 0.8], np.float32),
                            color=np.array([0, 1, 1, 1], np.float32))]


def _jax_measurement():
    jm = japp.Measurement()
    p = japp.MeasurementHitPair(label="p", line_width=2.5, color=(1.0, 0.5, 0.0, 0.8))
    p.hits[0].pos = np.array([-0.6, 0.1, 0.0], np.float32)
    p.hits[1].pos = np.array([0.5, -0.2, 0.3], np.float32)
    jm.hit_pairs.append(p)
    return jm


def _brush_session(jshapes, jm):
    """A CPU session with gizmos, a measurement pair and a brush gesture in
    progress in texture mode (the tint and the ring both drawn)."""
    s = app.GaussianSplattingSession(width=W, height=H, device="cpu")
    s.camera.control.pos = np.array([0.4, 0.3, -3.0], np.float32)
    s.viewer.update_camera(s.camera.control)
    for js in jshapes:
        s.mask.add_shape(convert.mask_shape_from_jax(js))
    s.measurement = convert.measurement_from_jax(jm)
    s.action = app.Action.SELECTION
    s.selection.method = app.SelectionMethod.BRUSH
    s.selection.brush_radius = 14
    s.toolset.update_brush_radius(14.0)
    s.toolset.set_use_texture(True)
    s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp.ADD, BRUSH[0])
    s.toolset.update_pos(BRUSH[1])
    return s


def test_session_overlays_match_jax():
    """Gizmos, measurement lines, texture tint, brush ring: the session's
    one `render_overlays` call against the JAX functions in turn."""
    jshapes, jm = _jax_shapes(), _jax_measurement()
    s = _brush_session(jshapes, jm)
    img = (np.random.default_rng(0).random((H, W, 3)) * 0.6).astype(np.float32)
    view, proj = s.viewer._view, s.viewer._proj
    tex = s.toolset.texture.numpy()
    assert 0 < tex.sum() < tex.size
    ref = jmask.render_mask_gizmos(jnp.asarray(img), jshapes, view, proj)
    ref = japp.render_measurement_overlay(ref, jm, view, proj)
    ref = jquery.overlay_texture(ref, jnp.asarray(tex))
    ref = np.asarray(jquery.overlay_cursor_ring(ref, jnp.asarray(BRUSH[1], jnp.float32),
                                                jnp.float32(14.0)))
    got = s.render_overlays(torch.from_numpy(img)).numpy()
    assert (np.abs(ref - img).max(-1) > 0).sum() > 2000
    assert np.abs(got - ref).max() <= LINE_TOL


def _segments(rng, m: int, h: int, w: int, length: float):
    """m segments, some dead, transparent, off screen or with non-finite
    ends, widths 0-8, as numpy (a, b, colors, widths, live)."""
    a = (rng.random((m, 2)) * [w * 1.4, h * 1.4] - [w * 0.2, h * 0.2]).astype(np.float32)
    b = (a + rng.normal(0.0, length, (m, 2))).astype(np.float32)
    col = rng.random((m, 4)).astype(np.float32)
    col[::4, 3] = 1.0
    col[1, 3] = 0.0
    a[2, 0], b[3, 1] = np.nan, np.inf
    a[4], b[4] = (-50.0, -50.0), (-20.0, -30.0)
    b[5] = a[5]
    lw = (rng.random(m) * 8).astype(np.float32)
    lw[6] = 0.0
    live = rng.random(m) < 0.9
    live[4:7], live[7] = True, False
    return a, b, col, lw, live


def test_segment_table_keeps_live_opaque_finite_in_order():
    """The table's rows are the live, non-transparent segments with finite
    ends, in order, each column as the per-pixel evaluation needs it."""
    rng = np.random.default_rng(2)
    a, b, col, lw, live = _segments(rng, 40, 48, 64, 12.0)
    table = lines.segment_table(a, b, col, lw, live, 64, 48)
    keep = live & (col[:, 3] != 0) & np.isfinite(a).all(1) & np.isfinite(b).all(1)
    assert not keep[[1, 2, 3, 7]].any() and keep.sum() == len(table) > 20
    assert table.dtype == np.float32 and table.shape == (keep.sum(), lines.SEG_WORDS)
    f32 = np.float32
    a, b, col, lw = a[keep], b[keep], col[keep], lw[keep]
    ab = b - a
    assert np.array_equal(table[:, :4], np.concatenate([a, ab], 1))
    denom = np.maximum((ab[:, 1].astype(np.float64) * ab[:, 1] + ab[:, 0] * ab[:, 0])
                       .astype(f32), f32(1e-9))
    assert np.array_equal(table[:, lines.SEG_DENOM], denom)
    assert np.array_equal(table[:, lines.SEG_REACH], np.maximum(lw * f32(0.5), f32(0.5)) + f32(0.5))
    assert np.array_equal(table[:, lines.SEG_ALPHA], col[:, 3])
    assert np.array_equal(table[:, lines.SEG_RGB], col[:, :3])
    assert not table[:, [7, 11]].any()
    x0, y0, x1, y1 = table[:, lines.SEG_BOX].T
    reach = np.maximum(lw * f32(0.5), f32(0.5)) + f32(1.5)
    assert np.array_equal(x0, np.clip(np.floor(np.minimum(a[:, 0], b[:, 0]) - reach), 0, 64))
    assert np.array_equal(y1, np.clip(np.ceil(np.maximum(a[:, 1], b[:, 1]) + reach), 0, 48))
    off_screen = np.searchsorted(np.flatnonzero(keep), 4)  # segment 4's row
    assert (x0 <= x1).all() and (y0 <= y1).all() and x0[off_screen] == x1[off_screen] == 0
    assert len(lines.segment_table(a[:0], b[:0], col[:0], lw[:0], live[:0], 64, 48)) == 0


def _rasterize_data(seed: int):
    """tests/test_torch_mask.py::test_rasterize_lines_match_jax's data."""
    rng = np.random.default_rng(seed)
    h, w, m = 96, 128, 60
    img = rng.random((h, w, 3)).astype(np.float32)
    a = (rng.random((m, 2)) * [w * 1.4, h * 1.4] - [w * 0.2, h * 0.2]).astype(np.float32)
    b = (rng.random((m, 2)) * [w * 1.4, h * 1.4] - [w * 0.2, h * 0.2]).astype(np.float32)
    col = rng.random((m, 4)).astype(np.float32)
    col[::4, 3] = 1.0
    col[5, 3] = 0.0
    lw = (rng.random(m) * 5).astype(np.float32)
    live = rng.random(m) < 0.9
    return img, (a, b, col, lw, live)


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_lines_plain_equals_image_before_k9(seed):
    img, segs = _rasterize_data(seed)
    got = lines.rasterize_lines_plain(torch.from_numpy(img), *segs).numpy()
    assert hashlib.sha256(got.tobytes()).hexdigest() == PARENT_DIGESTS[seed]
    assert torch.equal(lines.rasterize_lines(torch.from_numpy(img), *segs), torch.from_numpy(got))


def _fma(a, b, c):
    return (np.float64(a) * b + c).astype(np.float32)


def _torch_sqrt(x):
    return torch.sqrt(torch.from_numpy(np.ascontiguousarray(x))).numpy()


def _k9(img, table, texture=None, tint=TEXTURE_RGBA, ring=None, ring_sqrt=np.sqrt):
    """K9 (`csrc/overlay.cu`) in numpy, in the kernel's order: for each
    16x16 tile, the table rows whose non-empty box meets the tile, in order;
    for each, the tile's pixels inside its box take its cover (f32 steps,
    each fma an f64 add of the exact product rounded to f32), and those
    with cover > 0 its f64 blend; then the tint, then the ring
    (`ring` = (cx, cy, radius, thickness, rgba)), in f32. The ring's root
    is `ring_sqrt`: K9's and torch's CUDA sqrt are IEEE, as numpy's is, but
    torch's CPU sqrt in f32 is an ulp off now and then, so a comparison
    with the plain ring on the CPU passes `_torch_sqrt`."""
    f32, f64 = np.float32, np.float64
    h, w = img.shape[:2]
    out = img.copy()
    for ty in range(0, h, 16):
        for tx in range(0, w, 16):
            fy, fx = (v.astype(f32) for v in np.mgrid[ty:min(ty + 16, h), tx:min(tx + 16, w)])
            xs, ys = fx + f32(0.5), fy + f32(0.5)
            rgb = out[ty:ty + 16, tx:tx + 16]
            for row in table:
                x0, y0, x1, y1 = row[lines.SEG_BOX]
                if not (x0 < x1 and y0 < y1 and x0 < tx + 16 and x1 > tx and y0 < ty + 16
                        and y1 > ty):
                    continue
                inbox = (fx >= x0) & (fx < x1) & (fy >= y0) & (fy < y1)
                t = _fma(xs - row[0], row[2], (ys - row[1]) * row[3]) / row[4]
                t = np.minimum(np.maximum(t, f32(0)), f32(1))
                dx = xs - _fma(t, row[2], row[0])
                dy = ys - _fma(t, row[3], row[1])
                dist = np.sqrt(_fma(dx, dx, dy * dy))
                cover = np.minimum(np.maximum(row[5] - dist, f32(0)), f32(1)) * row[6]
                on = inbox & (cover > 0)
                keep = (f32(1) - cover).astype(f64)
                for c in range(3):
                    blend = (rgb[..., c].astype(f64) * keep + (cover * row[8 + c]).astype(f64))
                    rgb[..., c] = np.where(on, blend.astype(f32), rgb[..., c])
            if texture is not None:
                t = texture[ty:ty + 16, tx:tx + 16].astype(f32) * f32(tint[3])
                for c in range(3):
                    rgb[..., c] = rgb[..., c] * (f32(1) - t) + t * f32(tint[c])
            if ring is not None:
                cx, cy, radius, thick, rgba = ring
                ddx, ddy = xs - f32(cx), ys - f32(cy)
                d = ring_sqrt(ddx * ddx + ddy * ddy)
                cover = np.minimum(np.maximum(f32(thick) - np.abs(d - f32(radius)), f32(0)),
                                   f32(1)) * f32(rgba[3])
                for c in range(3):
                    rgb[..., c] = rgb[..., c] * (f32(1) - cover) + cover * f32(rgba[c])
    return out


def test_k9_order_equals_plain_lines():
    """40 segments over 48x64: K9's per-tile order gives the plain
    version's image bit for bit."""
    rng = np.random.default_rng(5)
    segs = _segments(rng, 40, 48, 64, 12.0)
    img = rng.random((48, 64, 3)).astype(np.float32)
    table = lines.segment_table(*segs, 64, 48)
    want = lines.rasterize_lines_plain(torch.from_numpy(img), *segs).numpy()
    got = _k9(img, table)
    assert (np.abs(want - img).max(-1) > 0).sum() > 300
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


class _K9Library:
    """A stand-in for the kernel library: its `gs_overlay` runs `_k9` on
    the CPU tensors behind the pointers it is handed."""

    def __init__(self, ring_sqrt):
        self.calls, self.ring_sqrt = [], ring_sqrt

    def gs_overlay(self, params, h, w, n, has_ring, img, table, texture, out, stream):
        def array(ptr, count, ctype):
            return np.ctypeslib.as_array((ctype * count).from_address(ptr))

        prm = np.array(list(params), np.float32)
        self.calls.append((prm, h, w, n, has_ring, stream))
        assert (table is None) == (n == 0) and img != out
        tab = array(table, n * lines.SEG_WORDS, ctypes.c_float).reshape(n, -1) if n \
            else np.zeros((0, lines.SEG_WORDS), np.float32)
        tex = None if texture is None else array(texture, h * w, ctypes.c_bool).reshape(h, w)
        ring = (prm[8], prm[9], prm[10], prm[11], prm[4:8]) if has_ring else None
        src = array(img, h * w * 3, ctypes.c_float).reshape(h, w, 3)
        array(out, h * w * 3, ctypes.c_float)[:] = _k9(src, tab, tex, prm[0:4], ring,
                                                        self.ring_sqrt).ravel()
        return 0


@pytest.fixture
def stand_in(monkeypatch):
    """`overlay_cuda` on CPU tensors through `_K9Library` (the ring's root
    the plain version's); the launch count is put back afterwards."""
    lib = _K9Library(_torch_sqrt)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require", _require_cpu)
    monkeypatch.setattr(kernels, "stream", lambda: 7)
    monkeypatch.setattr(torch.Tensor, "pin_memory", lambda self: self)
    lib.before = kernels.LAUNCHES["overlay"]
    yield lib
    kernels.LAUNCHES["overlay"] = lib.before


def _require_cpu(t, name, dtype, shape, device=None):
    assert t.dtype == dtype and tuple(t.shape) == tuple(shape) and t.is_contiguous(), name


@pytest.mark.parametrize("stages", ["lines", "lines+tint", "lines+tint+ring", "ring"])
def test_overlay_wrapper_through_stand_in_equals_plain(stand_in, stages):
    """`overlay_cuda` hands K9 the table, the texture, the tint's and the
    ring's parameters as the kernel reads them: its image equals the plain
    versions in turn, bit for bit, in one launch."""
    rng = np.random.default_rng(8)
    h, w = 96, 128
    segs = _segments(rng, 50, h, w, 30.0)
    img = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32))
    tex = torch.from_numpy(rng.random((h, w)) < 0.3)
    center, radius = np.array([70.3, 41.7], np.float32), 23.5
    want = img
    table = texture = cursor = None
    if "lines" in stages:
        want = lines.rasterize_lines_plain(want, *segs)
        table = lines.segment_table(*segs, w, h)
    if "tint" in stages:
        want = overlay_texture_plain(want, tex, (0.2, 0.9, 0.4, 0.35))
        texture = tex
    if "ring" in stages:
        want = overlay_cursor_ring_plain(want, center, radius, CURSOR_RGBA, 2.25)
        cursor = (center, radius)
    got = overlay_cuda(img, table, texture, (0.2, 0.9, 0.4, 0.35), cursor, CURSOR_RGBA, 2.25)
    [(prm, ch, cw, n, has_ring, stream)] = stand_in.calls
    assert (ch, cw, n, has_ring, stream) == (h, w, 0 if table is None else len(table),
                                             int(cursor is not None), 7)
    assert kernels.LAUNCHES["overlay"] == stand_in.before + 1
    assert np.array_equal(prm[:8], np.float32([0.2, 0.9, 0.4, 0.35, *CURSOR_RGBA]))
    assert not torch.equal(want, img)
    assert torch.equal(got, want)


def test_cpu_entry_points_launch_nothing_and_need_no_nvcc(monkeypatch):
    """On CPU tensors the overlays run their plain versions: no build, no
    launch; `overlay_cuda` refuses a CPU image before it builds."""
    def no_build():
        raise AssertionError("the kernel library was asked for on the CPU")

    monkeypatch.setattr(kernels, "library", no_build)
    monkeypatch.setattr(kernels, "_nvcc", no_build)
    assert kernels.LAUNCHES["overlay"] == 0
    rng = np.random.default_rng(9)
    segs = _segments(rng, 20, 96, 128, 20.0)
    img = torch.from_numpy(rng.random((96, 128, 3)).astype(np.float32))
    tex = torch.from_numpy(rng.random((96, 128)) < 0.5)
    one = draw_overlays(img, segs, tex, ((40.0, 50.0), 12.0))
    seq = overlay_cursor_ring(overlay_texture(lines.rasterize_lines(img, *segs), tex),
                              (40.0, 50.0), 12.0)
    assert torch.equal(one, seq) and not torch.equal(one, img)
    assert draw_overlays(img) is img
    assert kernels.LAUNCHES["overlay"] == 0
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        overlay_cuda(img, lines.segment_table(*segs, 128, 96))
