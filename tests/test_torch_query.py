"""Port queries (`query/`) against the JAX package on the same
`PreprocessOut` (the JAX preprocess's arrays handed to both sides).

Tolerance: selection bits, query textures and toolset pods equal exactly
(both sides test the same f32 values against f32-rounded regions); hit
queries give the same `found` and a position within 1e-4 (the ray is
scaled by the same depth; the products round an ulp apart); overlays
within 1e-6. Inputs have no depth ties: the port's hit sort is stable,
JAX's argsort is not.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu import query as jq
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu.data import (Compressions, Cov3dCompression, ShCompression,
                                           make_random_scene, pack_gaussians)
from wgpu_3dgs_viewer_app_tpu.ops import preprocess as j_preprocess
from wgpu_3dgs_viewer_app_tpu.query import selection as jsel
from wgpu_3dgs_viewer_app_tpu_torch import query as tq
from wgpu_3dgs_viewer_app_tpu_torch.ops import PreprocessOut
from wgpu_3dgs_viewer_app_tpu_torch.query import selection as tsel

W = H = 128
FULL = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)
OPS = [jq.QuerySelectionOp.SET, jq.QuerySelectionOp.ADD, jq.QuerySelectionOp.REMOVE]


def _top(op):
    """The port's op of the same name."""
    return tq.QuerySelectionOp(op.value)


@functools.lru_cache(maxsize=None)
def _scene(kind):
    """(JAX PreprocessOut, port PreprocessOut, n, view, proj, positions)."""
    if kind == "grid":  # tests/test_query.py's 10 x 10 grid
        g = make_random_scene(100, seed=1, extent=0.0, scale_range=(0.02, 0.03))
        xs = np.linspace(-1, 1, 10)
        gx, gy = np.meshgrid(xs, xs)
        g.pos = np.stack([gx.ravel(), gy.ravel(), np.zeros(100)], -1).astype(np.float32)
    elif kind == "pair":  # two big opaque splats, one behind the other
        g = make_random_scene(2, seed=0, extent=0.0, scale_range=(0.2, 0.2001))
        g.pos = np.array([[0, 0, 0], [0, 0, 2.0]], np.float32)
        g.opacity[:] = 4.0
        g.rot = np.tile(np.array([1, 0, 0, 0], np.float32), (2, 1))
    else:
        g = make_random_scene(1500, seed=7, extent=1.2, scale_range=(0.01, 0.06))
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = cam.view(), cam.projection(1.0)
    pod = {k: jnp.asarray(v) for k, v in pack_gaussians(g, FULL).items()}
    jpre = j_preprocess(pod, FULL, jnp.asarray(view), jnp.asarray(proj), jnp.eye(4), W, H)
    # The JAX pod pads to 128 splats; the port's PreprocessOut has n.
    tpre = PreprocessOut(**{f: torch.from_numpy(np.array(getattr(jpre, f))[:g.count])
                            for f in PreprocessOut.__dataclass_fields__})
    return jpre, tpre, g.count, view, proj, g.pos


def _eq(a, b):
    """JAX result `a` (per-splat ones cut to the port's n) equals port `b`."""
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    a = np.asarray(a)
    assert np.array_equal(a[: b.shape[0]] if a.ndim == 1 else a, b)


@pytest.mark.parametrize("kind", ["grid", "random"])
def test_select_rect_and_brush_bit_equal(kind):
    jpre, tpre, _, _, _, _ = _scene(kind)
    for tl, br in [((0, 0), (W / 2, H)), ((100.5, 90.0), (20.25, 10.0)), ((33, 40), (33, 80))]:
        got = tsel.select_rect(tpre, tl, br)
        assert got.dtype == torch.uint8
        _eq(jsel.select_rect(jpre, tl, br), got)
    for a, b, r in [((0, H / 2), (W, H / 2), 8.0), ((10, 10), (10, 10), 30.0),
                    ((5.5, 120), (90, 3.25), 12.5)]:
        ja, jb = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)
        _eq(jsel.select_brush_segment(jpre, ja, jb, jnp.float32(r)),
            tsel.select_brush_segment(tpre, a, b, r))


@pytest.mark.parametrize("op", OPS, ids=lambda o: o.value)
def test_combine_selection_bit_equal(op):
    rng = np.random.default_rng(3)
    old, new = (rng.integers(0, 2, 500).astype(np.uint8) for _ in range(2))
    got = tsel.combine_selection(torch.from_numpy(old), torch.from_numpy(new), _top(op))
    assert got.dtype == torch.uint8
    _eq(jsel.combine_selection(jnp.asarray(old), jnp.asarray(new), op), got)


def test_texture_paint_and_sample_bit_equal():
    jpre, tpre, _, _, _, _ = _scene("random")
    jtex = jsel._paint_segment(jnp.zeros((H, W), bool), jnp.asarray([5.0, 60.0]),
                               jnp.asarray([110.0, 20.0]), jnp.float32(14.0))
    jtex = jsel._paint_rect(jtex, jnp.asarray([90.0, 80.0]), jnp.asarray([60.0, 120.0]))
    ttex = torch.zeros((H, W), dtype=torch.bool)
    ttex = tsel._paint_segment(ttex, (5.0, 60.0), (110.0, 20.0), 14.0)
    ttex = tsel._paint_rect(ttex, (90.0, 80.0), (60.0, 120.0))
    _eq(jtex, ttex)
    bits = tsel.sample_texture_at_centers(tpre, ttex)
    assert int(bits.sum()) > 20
    _eq(jsel.sample_texture_at_centers(jpre, jtex), bits)


def _gesture(ts_cls, ops, device_kw):
    ts = ts_cls(W, H, **device_kw)
    results = []
    for step in ops:
        name, *args = step
        results.append(getattr(ts, name)(*args))
    return ts, results


def _same_pods(jp, tp):
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        assert type(a).__name__ == type(b).__name__
        for f in a.__dataclass_fields__:
            va, vb = getattr(a, f), getattr(b, f)
            if f == "op":
                assert va.value == vb.value
            else:
                assert np.array_equal(np.asarray(va, np.float32), np.asarray(vb, np.float32)), f


@pytest.mark.parametrize("gesture", ["immediate_rect", "texture_brush", "brush_set_keeps_path"])
def test_toolset_gestures_match_jax(gesture):
    """The gesture cases of tests/test_query.py on both toolsets: the same
    pods, the same query texture and the same selection bits."""
    jpre, tpre, n, _, _, _ = _scene("grid")
    set_, = [o for o in OPS if o.value == "set"]
    if gesture == "immediate_rect":
        steps = [("set_use_texture", False), ("start", "rect", "@SET", (0, 0)),
                 ("update_pos", (W / 2, H)), ("end",)]
    elif gesture == "texture_brush":
        steps = [("set_use_texture", True), ("update_brush_radius", 8),
                 ("start", "brush", "@SET", (0, H / 2)), ("update_pos", (W, H / 2)), ("end",)]
    else:
        steps = [("set_use_texture", False), ("start", "brush", "@SET", (10, 10)),
                 ("update_pos", (50, 10)), ("update_pos", (90, 10))]
    jsteps = [tuple(set_ if a == "@SET" else a for a in s) for s in steps]
    tsteps = [tuple(_top(set_) if a == "@SET" else a for a in s) for s in steps]
    jts, jres = _gesture(jq.QueryToolset, jsteps, {})
    tts, tres = _gesture(tq.QueryToolset, tsteps, {"device": "cpu"})
    _eq(jts.texture, tts.texture)
    jpods, tpods = jts.query(), tts.query()
    _same_pods(jpods, tpods)
    jbits = jnp.zeros(jpre.valid.shape[0], jnp.uint8)  # the JAX side's padded length
    tbits = torch.zeros(n, dtype=torch.uint8)
    if gesture == "texture_brush":
        (jop, jtex), (top, ttex) = jres[-1], tres[-1]
        assert jop.value == top.value
        jbits = jsel.combine_selection(jbits, jsel.sample_texture_at_centers(jpre, jtex), jop)
        tbits = tsel.combine_selection(tbits, tsel.sample_texture_at_centers(tpre, ttex), top)
    for jp, tp in zip(jpods, tpods):
        jbits = jsel.apply_query_pod(jpre, jbits, jp)
        tbits = tsel.apply_query_pod(tpre, tbits, tp)
    assert int(tbits.sum()) > 0
    _eq(jbits, tbits)


@pytest.mark.parametrize("method", list(jq.MeasurementHitMethod), ids=lambda m: m.value)
@pytest.mark.parametrize("kind", ["pair", "random"])
def test_query_hit_matches_jax(method, kind):
    """Both methods at several pixels: the same `found`, pos within 1e-4."""
    jpre, tpre, _, view, proj, _ = _scene(kind)
    tmethod = tq.MeasurementHitMethod(method.value)
    hits = 0
    for pixel in [(W / 2, H / 2), (2.0, 2.0), (40.5, 70.25), (90.0, 33.0)]:
        jf, jp = jq.query_hit(jpre, jnp.asarray(pixel, jnp.float32), jnp.asarray(view),
                              jnp.asarray(proj), W, H, method)
        tf, tp = tq.query_hit(tpre, pixel, view, proj, W, H, tmethod)
        assert bool(jf) == bool(tf), pixel
        if bool(jf):
            hits += 1
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4, err_msg=str(pixel))
    assert hits >= 1
    alpha = tq.alpha_at_pixel(tpre, (W / 2, H / 2)).numpy()
    ref = jq.alpha_at_pixel(jpre, jnp.asarray([W / 2, H / 2], jnp.float32))
    np.testing.assert_allclose(alpha, np.asarray(ref)[: alpha.shape[0]], atol=1e-6)


def test_overlays_match_jax():
    rng = np.random.default_rng(5)
    img = rng.random((H, W, 3)).astype(np.float32)
    tex = rng.random((H, W)) > 0.5
    got = tq.overlay_texture(torch.from_numpy(img), torch.from_numpy(tex))
    np.testing.assert_allclose(got.numpy(), np.asarray(jq.overlay_texture(jnp.asarray(img),
                                                                           jnp.asarray(tex))),
                               atol=1e-6)
    got = tq.overlay_cursor_ring(torch.from_numpy(img), (40.0, 70.5), 23.0)
    ref = jq.overlay_cursor_ring(jnp.asarray(img), jnp.asarray([40.0, 70.5]), jnp.float32(23.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
