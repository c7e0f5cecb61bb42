"""The port's app layer on the CPU against the JAX package: one
`GaussianSplattingSession` of each package fed the same PLY bytes (streamed
in), the same camera, mask shapes and op code (sent as EvaluateMask through
the command bus), the same hit clicks, rect gesture, selection edit,
exports and preferences. Held: the masked `update()` frame and the frame
with the measurement line to the port's viewer gate (`assert_golden_close`),
the mask bits, selection bits and edit records equal, the hit positions
within 1e-4, the export's PLY bytes and the saved-state JSON equal. Also the
loader, the utils, the large-tile plain compositors against the JAX jnp
compositors, and that the new modules never name JAX."""

import io
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu import app as japp
from wgpu_3dgs_viewer_app_tpu import mask as jmask
from wgpu_3dgs_viewer_app_tpu import query as jquery
from wgpu_3dgs_viewer_app_tpu import utils as jutils
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops import composite as jcomp
from wgpu_3dgs_viewer_app_tpu_torch import app, convert, query, utils
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, read_ply, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.ops import (TileConfig, build_entry_planes,
                                                build_sorted_entries_fused, build_tile_lists,
                                                composite_tiles, composite_tiles_v2, preprocess)
from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import PLANE_FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 128
N = 3000
# Hit positions: the query geometry of the two packages differs by rounding.
HIT_TOL = 1e-4
# Plain compositors against the JAX jnp compositors on the same entries
# (the reference's own tolerance for its compositors, tests/test_pipeline.py).
COMPOSITE_TOL = 1e-5
HITS = [(64, 64), (52, 76)]
RECT = ((20.0, 24.0), (100.0, 90.0))


def _u8(img):
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8).astype(np.int16)


def _jax_shapes():
    J = jmask.MaskShapeKind
    return [jmask.MaskShape(kind=J.BOX, scale=np.array([1.2, 1.2, 1.2], np.float32)),
            jmask.MaskShape(kind=J.ELLIPSOID, pos=np.array([0.4, 0.0, 0.0], np.float32),
                            rot=np.array([0, 30, 20], np.float32),
                            scale=np.array([0.9, 1.2, 0.8], np.float32),
                            color=np.array([0, 1, 1, 1], np.float32)),
            jmask.MaskShape(kind=J.BOX, pos=np.array([-0.4, 0.3, 0.0], np.float32),
                            scale=np.array([0.5, 0.5, 0.5], np.float32),
                            color=np.array([1, 0, 1, 1], np.float32))]


def _scenario(a, q, session, shapes, ply_bytes, tmp_dir) -> dict:
    """The same steps on a session of either package (`a`: its app module,
    `q`: its query module); returns what each step produced, as numpy."""
    rec = {}
    ctl = session.camera.control
    ctl.target = np.zeros(3, np.float32)
    ctl.pos = np.array([0.3, 0.2, -3.0], np.float32)
    session.open_model("m.ply", io.BytesIO(ply_bytes))
    while session.loader is not None:
        session._drain_loader()
    m = session.viewer.models["m.ply"]
    rec["pos"] = np.asarray(m.gaussians.pos)
    rec["loaded"] = len(m.buffers)
    for s in shapes:
        session.mask.add_shape(s)
    session.mask.op_code = "(0 | 1) - 2"
    session.send_command(a.SceneCommand(a.SceneCommandKind.EVALUATE_MASK,
                                        mask_op=session.mask.parse_op()))
    rec["frame_masked"] = np.asarray(session.update())
    rec["mask"] = m.buffers.download_mask()
    rec["hits"] = [session.locate_hit(px, 0, i) for i, px in enumerate(HITS)]
    rec["hit_pos"] = [np.asarray(h.pos) for h in session.measurement.hit_pairs[0].hits]
    rec["frame_measured"] = np.asarray(session.update())
    session.action = a.Action.SELECTION
    session.toolset.set_use_texture(False)
    session.toolset.start(q.QueryToolset.RECT, q.QuerySelectionOp.SET, RECT[0])
    session.toolset.update_pos(RECT[1])
    session.end_selection_gesture()
    rec["selection"] = m.buffers.download_selection()
    session.selection.edit = a.SelectionEdit(hsv=(0.2, 1.1, 0.9), alpha=0.5)
    session.commit_selection_edit()
    rec["edits"] = m.buffers.download_edits()
    for key, choice in (("export_mask", a.ExportChoice(with_edit=False, with_mask=True)),
                        ("export_all", a.ExportChoice())):
        buf = io.BytesIO()
        assert a.export_models(session.viewer, buf, {"m.ply": choice}) == ["m.ply"]
        rec[key] = buf.getvalue()
    session.gaussian_transform.size = 0.8
    session.camera.speed = 2.5
    session.theme = "light"
    path = os.path.join(tmp_dir, "state.json")
    a.save_state(session, path)
    with open(path) as f:
        rec["state_json"] = f.read()
    return rec


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sessions through the scenario, once per module."""
    g = make_random_scene(N, seed=11, extent=1.0, scale_range=(0.01, 0.05))
    buf = io.BytesIO()
    write_ply(buf, g)
    jshapes = _jax_shapes()
    jsession = japp.GaussianSplattingSession(width=W, height=H, use_pallas=False, tile=16,
                                             max_dup=8)
    tsession = app.GaussianSplattingSession(width=W, height=H, device="cpu", tile=16, max_dup=8)
    ref = _scenario(japp, jquery, jsession, jshapes, buf.getvalue(),
                    str(tmp_path_factory.mktemp("jax")))
    got = _scenario(app, query, tsession, [convert.mask_shape_from_jax(s) for s in jshapes],
                    buf.getvalue(), str(tmp_path_factory.mktemp("port")))
    return g, ref, got, tsession


def test_session_streams_the_model_in(runs):
    g, ref, got, _ = runs
    assert got["loaded"] == ref["loaded"] == N
    assert np.array_equal(got["pos"], ref["pos"]) and np.array_equal(got["pos"], g.pos)


def test_session_mask_bits_match_jax(runs):
    """EvaluateMask through the command bus: the mask bits equal."""
    _, ref, got, _ = runs
    assert got["mask"].dtype == np.uint8 and np.array_equal(got["mask"], ref["mask"])
    assert 0.1 < got["mask"].mean() < 0.9


@pytest.mark.parametrize("frame", ["frame_masked", "frame_measured"])
def test_session_frame_matches_jax(runs, frame):
    """The `update()` frame after the mask (with its gizmos), and with the
    measurement line: within the viewer's golden gate of the JAX frame."""
    _, ref, got, _ = runs
    assert got[frame].shape == ref[frame].shape == (H, W, 3)
    assert float(got[frame].max(axis=-1).__gt__(0.02).mean()) > 0.1
    assert_golden_close(_u8(got[frame]), _u8(ref[frame]))


def test_session_hits_match_jax(runs):
    _, ref, got, _ = runs
    assert got["hits"] == ref["hits"] == [True, True]
    for a, b in zip(got["hit_pos"], ref["hit_pos"]):
        assert np.abs(a - b).max() <= HIT_TOL
    assert got["hit_pos"][0].dtype == np.float32


def test_session_selection_and_commit_match_jax(runs):
    _, ref, got, _ = runs
    assert np.array_equal(got["selection"], ref["selection"])
    assert 0 < got["selection"].sum() < N
    for a, b in zip(got["edits"], ref["edits"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("key", ["export_mask", "export_all"])
def test_session_export_matches_jax(runs, key):
    """The mask-filtered export (and the one with the edits baked too): the
    PLY bytes equal; the masked export holds the kept splats."""
    _, ref, got, _ = runs
    assert got[key] == ref[key]
    if key == "export_mask":
        assert read_ply(io.BytesIO(got[key])).count == int(got["mask"].sum())


def test_session_saved_state_matches_jax(runs, tmp_path):
    _, ref, got, tsession = runs
    assert got["state_json"] == ref["state_json"]
    path = tmp_path / "state.json"
    path.write_text(ref["state_json"])
    fresh = app.GaussianSplattingSession(width=32, height=32, device="cpu")
    assert app.restore_state(fresh, path)
    assert fresh.gaussian_transform.size == tsession.gaussian_transform.size == 0.8
    assert fresh.camera.speed == 2.5 and fresh.theme == "light"
    assert app.load_compressions(path) == tsession.compressions
    assert not app.restore_state(fresh, tmp_path / "missing.json")


def test_session_reset_frame_equals_unmasked():
    """EvaluateMask(None) sets every bit: the frame equals one never masked,
    bit for bit, and the gizmos draw over it only where they lie."""
    g = make_random_scene(800, seed=2, extent=1.0, scale_range=(0.02, 0.06))
    buf = io.BytesIO()
    write_ply(buf, g)
    frames = []
    for reset in (False, True):
        s = app.GaussianSplattingSession(width=64, height=48, device="cpu", tile=16)
        s.open_model("m.ply", io.BytesIO(buf.getvalue()))
        while s.loader is not None:
            s._drain_loader()
        if reset:
            s.mask.add_shape()
            s.mask.op_code = "0"
            s.evaluate_mask(s.mask.parse_op())
            assert not s.viewer.models["m.ply"].buffers.download_mask().all()
            s.send_command(app.SceneCommand(app.SceneCommandKind.EVALUATE_MASK, mask_op=None))
            s.mask.shapes[0].visible = False
        frames.append(s.update())
    assert s.viewer.models["m.ply"].buffers.download_mask().all()
    assert torch.equal(frames[0], frames[1])


def test_session_overlays_in_one_pass_equal_two():
    """`render_overlays` draws the gizmos' and the measurement's segments in
    one pass: the image equals the gizmos drawn, then the lines, bit for
    bit."""
    from wgpu_3dgs_viewer_app_tpu_torch.app.measurement import render_measurement_overlay
    from wgpu_3dgs_viewer_app_tpu_torch.mask import render_mask_gizmos

    s = app.GaussianSplattingSession(width=160, height=120, device="cpu")
    s.camera.control.pos = np.array([0.4, 0.3, -3.0], np.float32)
    s.viewer.update_camera(s.camera.control)
    for js in _jax_shapes():
        s.mask.add_shape(convert.mask_shape_from_jax(js))
    pair = app.MeasurementHitPair(label="p", line_width=2.0)
    pair.hits[0].pos = np.array([-0.6, 0.1, 0.0], np.float32)
    pair.hits[1].pos = np.array([0.5, -0.2, 0.3], np.float32)
    s.measurement.hit_pairs.append(pair)
    img = torch.from_numpy(np.random.default_rng(0).random((120, 160, 3), dtype=np.float32))
    v, p = s.viewer._view, s.viewer._proj
    two = render_measurement_overlay(render_mask_gizmos(img, s.mask.shapes, v, p), s.measurement,
                                     v, p)
    one = s.render_overlays(img)
    assert torch.equal(one, two) and not torch.equal(one, img)


def test_session_command_bus_and_loading_rules():
    g = make_random_scene(300, seed=5)
    buf = io.BytesIO()
    write_ply(buf, g)
    s = app.GaussianSplattingSession(width=32, height=32, device="cpu")
    s.send_command(app.SceneCommand(app.SceneCommandKind.ADD_MODEL, file_name="x.ply",
                                    reader=io.BytesIO(buf.getvalue())))
    s.update()
    assert "x.ply" in s.viewer.models and s.selected_key == "x.ply"
    with pytest.raises(RuntimeError):
        s.open_model("y.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    # The default camera was framed on the loaded model.
    assert np.allclose(s.camera.control.target, g.center())
    s.open_model("x.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    assert set(s.viewer.models) == {"x.ply", "x.ply (1)"}
    s.send_command(app.SceneCommand(app.SceneCommandKind.REMOVE_MODEL, key="x.ply"))
    s.update()
    assert list(s.viewer.models) == ["x.ply (1)"] and s.selected_key == "x.ply (1)"


def test_loader_matches_jax():
    """The streaming loader of each package on the same bytes: the header
    count, the chunks' splats in order, the counters."""
    g = make_random_scene(2500, seed=9)
    buf = io.BytesIO()
    write_ply(buf, g)
    out = []
    for mod in (japp, app):
        ld = mod.StreamingLoader(io.BytesIO(buf.getvalue()))
        got = []
        while not ld.finished:
            ld.drain(on_chunk=lambda start, c: got.append((start, c.count, c.pos.copy())))
        out.append((ld.count, ld.received, ld.progress(), [(s, n) for s, n, _ in got],
                    np.concatenate([p for _, _, p in got])))
    assert out[0][:4] == out[1][:4] and out[1][0] == 2500
    assert np.array_equal(out[0][4], out[1][4])


def test_utils_match_jax():
    for n in (0, 1, 1023, 1024, 1536, 10 ** 6, 3 * 2 ** 30, 5 * 2 ** 40):
        assert utils.human_readable_size(n) == jutils.human_readable_size(n)
    assert utils.get_logger("x").name == jutils.get_logger("x").name
    done = []
    utils.exec_task(done.append, 1).join(5)
    assert done == [1]
    ld = app.Loadable()
    ld.post(error="bad")
    assert not ld.is_loaded and ld.error == "bad"
    ld.post(value=3)
    assert ld.is_loaded and ld.error is None
    fps = app.FpsCounter()
    for _ in range(5):
        fps.tick()
    assert fps.fps == 0.0


def test_new_modules_never_name_jax():
    """The port's mask, lines, utils and app modules import neither JAX nor
    the JAX package."""
    pkg = os.path.join(REPO, "wgpu_3dgs_viewer_app_tpu_torch")
    files = [os.path.join(pkg, "core", "lines.py")]
    for sub in ("mask", "utils", "app"):
        files += [os.path.join(pkg, sub, f) for f in sorted(os.listdir(os.path.join(pkg, sub)))
                  if f.endswith(".py")]
    assert len(files) >= 15
    bad = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|wgpu_3dgs_viewer_app_tpu)\b", re.M)
    for f in files:
        with open(f) as fh:
            assert not bad.search(fh.read()), f


# --- the plain compositors at tiles over 32 px, against the jnp compositors --


def _scene_pod(n=400, seed=3):
    from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words,
                                                     pack_gaussians, pod_to_tensors)
    from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl

    comp = Compressions()
    g = make_random_scene(n, seed=seed, extent=1.0, scale_range=(0.02, 0.1))
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), "cpu")
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.2, 0.3, -3.0))
    return pod, comp, cam


@pytest.mark.parametrize("tile", [48, 64, 128, 300])
def test_plain_v2_compositor_large_tiles_matches_jnp(tile):
    """The plain v2 compositor (K3's reference) against `composite_tiles_jnp_v2`
    on the same sorted entries at 160x128 (tile 300: one tile larger than the
    image, whose exit test reads pixels outside it)."""
    pod, comp, cam = _scene_pod()
    w, h = 160, 128
    cfg = TileConfig(w, h, tile=tile, max_dup=8)
    se = build_sorted_entries_fused(pod, comp, cfg, cam.view(), cam.projection(w / h),
                                    np.eye(4, dtype=np.float32))
    planes, starts, counts, n_valid = convert.sorted_entries_to_jax(se)
    jse = jbin.SortedEntries(jnp.asarray(planes), jnp.asarray(starts), jnp.asarray(counts),
                             jnp.asarray(n_valid))
    ref = np.asarray(jcomp.composite_tiles_jnp_v2(jse, jbin.TileConfig(w, h, tile=tile,
                                                                       max_dup=8)))
    got = composite_tiles_v2(se, cfg).numpy()
    assert got.shape == ref.shape == (h, w, 4) and got[..., 3].mean() > 0.1
    np.testing.assert_allclose(got, ref, atol=COMPOSITE_TOL)


@pytest.mark.parametrize("tile", [48, 64, 128, 300])
def test_plain_v1_compositor_large_tiles_matches_jnp(tile):
    """The plain v1 compositor (K6's reference) against `composite_tiles_jnp`
    on the same EntryPlanes at 160x128 (tile 300: one tile larger than the
    image)."""
    pod, comp, cam = _scene_pod()
    w, h = 160, 128
    cfg = TileConfig(w, h, tile=tile, max_dup=16)
    pre = preprocess(pod, comp, cam.view(), cam.projection(w / h), np.eye(4, dtype=np.float32),
                     w, h)
    planes = build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)
    jp = jbin.EntryPlanes(jnp.asarray(planes.ent.numpy()), jnp.asarray(planes.row_starts.numpy()),
                          jnp.asarray(planes.tile_counts.numpy()))
    ref = np.asarray(jcomp.composite_tiles_jnp(jp, jbin.TileConfig(w, h, tile=tile,
                                                                   max_dup=16)))
    got = composite_tiles(planes, cfg).numpy()
    assert planes.ent.shape[0] == len(PLANE_FIELDS)
    assert got.shape == ref.shape == (h, w, 4) and got[..., 3].mean() > 0.1
    np.testing.assert_allclose(got, ref, atol=COMPOSITE_TOL)
