"""The port's mask subsystem and line overlays on the CPU against the JAX
package: the op-code parser (every case of tests/test_mask.py, as equal
trees and equal errors), the shape pods, the mask bits of `MaskEvaluator`
byte for byte on 10k points (each op kind, box and rotated ellipsoid, with
and without a model transform, and Reset), and `project_points`,
`rasterize_lines`, the gizmo image and the measurement overlay within 1e-5
of JAX's. Inputs are made by numpy from a seed and handed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu import app as japp
from wgpu_3dgs_viewer_app_tpu import mask as jmask
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.core import ModelTransform as JModelTransform
from wgpu_3dgs_viewer_app_tpu.core import lines as jlines
from wgpu_3dgs_viewer_app_tpu_torch import convert, mask
from wgpu_3dgs_viewer_app_tpu_torch.app.measurement import render_measurement_overlay
from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform, lines

# Lines, gizmos and the measurement overlay. The port repeats the
# reference's fma contractions and dot order, so in practice they agree to
# an ulp or two.
LINE_TOL = 1e-5

PARSE_OK = ["", "   ", "3", "!0 | 1", "0 | 1 & 2 - 3 ^ 4", "0 - 1 - 2", "(0 | 1) & 2", "!(0 | 1)",
            "0 ^ 1", "0 & 1", "(0 | 1) - 2", "!!2 ^ (0 & !1)"]
PARSE_BAD = ["0 |", "(0", "0 1", "&", "a", "0 | 1)", "()"]


@pytest.mark.parametrize("src", PARSE_OK)
def test_parse_matches_jax(src):
    """Equal trees (kind, children, index) and equal printed forms."""
    ref, got = jmask.parse(src), mask.parse(src)
    assert got == convert.mask_op_from_jax(ref)
    assert str(got) == str(ref)


@pytest.mark.parametrize("src", PARSE_BAD)
def test_parse_errors_match_jax(src):
    with pytest.raises(jmask.MaskParseError) as ref:
        jmask.parse(src)
    with pytest.raises(mask.MaskParseError) as got:
        mask.parse(src)
    assert str(got.value) == str(ref.value)


def test_validate_shapes_matches_jax():
    for op in (jmask.parse("0 | 5"), mask.parse("0 | 5")):
        op.validate_shapes(6)
    with pytest.raises(mask.MaskParseError, match="shape index 5"):
        mask.parse("0 | 5").validate_shapes(5)


def _shapes(rng):
    """Three JAX shapes: a rotated box, a rotated ellipsoid, a box."""
    J = jmask.MaskShapeKind
    return [
        jmask.MaskShape(kind=J.BOX, pos=rng.normal(0, 0.3, 3).astype(np.float32),
                        rot=np.array([10, 35, -20], np.float32),
                        scale=np.array([1.5, 1.0, 1.2], np.float32)),
        jmask.MaskShape(kind=J.ELLIPSOID, pos=np.array([0.5, 0.0, 0.1], np.float32),
                        rot=np.array([0, 45, 30], np.float32),
                        scale=np.array([1.0, 1.6, 0.8], np.float32),
                        color=np.array([0, 1, 1, 1], np.float32)),
        jmask.MaskShape(kind=J.BOX, pos=np.array([-0.5, 0.4, 0], np.float32),
                        scale=np.array([0.6, 0.6, 0.6], np.float32),
                        color=np.array([1, 0, 1, 0.8], np.float32)),
    ]


def test_shape_pods_match_jax():
    for js in _shapes(np.random.default_rng(1)):
        ref, got = js.to_pod(), convert.mask_shape_from_jax(js).to_pod()
        assert got.kind.value == ref.kind.value
        assert got.inv_lin.dtype == np.float32 and got.inv_lin.tobytes() == ref.inv_lin.tobytes()
        assert got.pos.tobytes() == ref.pos.tobytes()
        carried = convert.mask_pod_from_jax(ref)
        assert carried.kind == got.kind and carried.inv_lin.tobytes() == got.inv_lin.tobytes()


def test_shape_contains_matches_reference_cases():
    """tests/test_mask.py's containment points through the port."""
    box = mask.MaskShape(kind=mask.MaskShapeKind.BOX, pos=np.array([1, 0, 0], np.float32),
                         rot=np.array([0, 0, 90], np.float32),
                         scale=np.array([2, 1, 1], np.float32)).to_pod()
    pts = torch.tensor([[1, 0, 0], [1, 0.9, 0], [1.6, 0, 0], [1, 1.1, 0]], dtype=torch.float32)
    assert mask.shape_contains(box, pts).tolist() == [True, True, False, False]
    ell = mask.MaskShape(kind=mask.MaskShapeKind.ELLIPSOID,
                         scale=np.array([2, 1, 1], np.float32)).to_pod()
    pts = torch.tensor([[0.9, 0, 0], [0, 0.9, 0], [0.9, 0.4, 0]], dtype=torch.float32)
    assert mask.shape_contains(ell, pts).tolist() == [True, False, False]


OPS = ["0", "1", "!1", "0 | 1", "0 & 1", "0 - 1", "0 ^ 1", "(0 | 1) - 2", None]


@pytest.mark.parametrize("transformed", [False, True], ids=["local", "transformed"])
@pytest.mark.parametrize("code", OPS, ids=lambda c: "reset" if c is None else c)
def test_mask_bits_match_jax(code, transformed):
    """10k points (as component planes, as the sessions pass them): the
    port's bits byte for byte equal to the JAX `MaskEvaluator`'s. Shape 0
    is a rotated box, 1 a rotated ellipsoid."""
    rng = np.random.default_rng(7)
    pts = rng.normal(0, 0.7, (10_000, 3)).astype(np.float32)
    jshapes = _shapes(rng)
    jpods = [s.to_pod() for s in jshapes]
    pods = [convert.mask_pod_from_jax(p) for p in jpods]
    jop = None if code is None else jmask.parse(code)
    jxf = xf = None
    if transformed:
        kw = dict(pos=np.array([0.2, -0.1, 0.3], np.float32),
                  rot=np.array([15, -30, 60], np.float32), scale=np.array([1.2, 0.9, 1.1],
                                                                          np.float32))
        jxf, xf = JModelTransform(**kw), ModelTransform(**kw)
    planes = (pts[:, 0], pts[:, 1], pts[:, 2])
    ref = np.asarray(jmask.MaskEvaluator().evaluate(jop, jpods, planes, jxf))
    got = mask.MaskEvaluator("cpu").evaluate(convert.mask_op_from_jax(jop), pods,
                                             planes, xf)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert ref.dtype == np.uint8 and got.numpy().tobytes() == ref.tobytes()
    if code is not None:
        assert 0 < int(got.sum()) < len(pts)
    assert np.array_equal(mask.evaluate_mask_numpy(convert.mask_op_from_jax(jop), pods, pts, xf),
                          ref)


def _camera(w, h):
    cam = JCamera(target=(0, 0, 0), pos=(0.6, 0.5, -4.0))
    return cam.view(), cam.projection(w / h)


def test_project_points_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.normal(0, 1.5, (500, 3)).astype(np.float32)
    view, proj = _camera(160, 120)
    ref = jlines.project_points(jnp.asarray(pts), jnp.asarray(view), jnp.asarray(proj), 160, 120)
    got = lines.project_points(pts, view, proj, 160, 120)
    for r, g in zip(ref, got):
        assert np.array_equal(np.asarray(r), g.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_rasterize_lines_match_jax(seed):
    """60 random segments (some off screen, some dead, some transparent)
    over a random image."""
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
    ref = np.asarray(jlines.rasterize_lines(jnp.asarray(img), jnp.asarray(a), jnp.asarray(b),
                                            jnp.asarray(col), jnp.asarray(lw),
                                            jnp.asarray(live)))
    got = lines.rasterize_lines(torch.from_numpy(img), a, b, col, lw, live).numpy()
    assert (np.abs(ref - img).max(-1) > 0).mean() > 0.2  # the lines cover a fifth
    assert np.abs(got - ref).max() <= LINE_TOL


def test_gizmo_segments_and_image_match_jax():
    """The three shapes' wireframes (12 + 96 + 12 segments) equal to the
    JAX ones, and their image over a random frame within 1e-5."""
    rng = np.random.default_rng(3)
    jshapes = _shapes(rng)
    shapes = [convert.mask_shape_from_jax(s) for s in jshapes]
    for js, s in zip(jshapes, shapes):
        assert np.array_equal(jmask.shape_segments(js), mask.shape_segments(s))
    h, w = 120, 160
    img = (rng.random((h, w, 3)) * 0.5).astype(np.float32)
    view, proj = _camera(w, h)
    ref = np.asarray(jmask.render_mask_gizmos(jnp.asarray(img), jshapes, view, proj))
    got = mask.render_mask_gizmos(torch.from_numpy(img), shapes, view, proj).numpy()
    assert (np.abs(ref - img).max(-1) > 0).sum() > 500
    assert np.abs(got - ref).max() <= LINE_TOL
    shapes[1].visible = False
    jshapes[1].visible = False
    ref = np.asarray(jmask.render_mask_gizmos(jnp.asarray(img), jshapes, view, proj))
    got = mask.render_mask_gizmos(torch.from_numpy(img), shapes, view, proj).numpy()
    assert np.abs(got - ref).max() <= LINE_TOL


def test_measurement_overlay_matches_jax():
    """Two visible hit pairs and a hidden one, different widths and colours."""
    rng = np.random.default_rng(4)
    jm = japp.Measurement()
    for i, (lw, vis) in enumerate([(1.0, True), (2.5, True), (3.0, False)]):
        p = japp.MeasurementHitPair(label=f"p{i}", line_width=lw, visible=vis,
                                    color=tuple(rng.random(4).astype(np.float32).tolist()))
        p.hits[0].pos = rng.normal(0, 0.8, 3).astype(np.float32)
        p.hits[1].pos = rng.normal(0, 0.8, 3).astype(np.float32)
        jm.hit_pairs.append(p)
    m = convert.measurement_from_jax(jm)
    assert [p.distance() for p in m.hit_pairs] == [p.distance() for p in jm.hit_pairs]
    h, w = 96, 128
    img = (rng.random((h, w, 3)) * 0.5).astype(np.float32)
    view, proj = _camera(w, h)
    ref = np.asarray(japp.render_measurement_overlay(jnp.asarray(img), jm, view, proj))
    got = render_measurement_overlay(torch.from_numpy(img), m, view, proj).numpy()
    assert (np.abs(ref - img).max(-1) > 0).sum() > 50
    assert np.abs(got - ref).max() <= LINE_TOL
