"""The port's whole slice on the CPU: `Viewer.render` against the JAX
viewer (ungated, and gated with a selection edit, highlight, committed
per-splat edits and a mask), the CLI against the committed golden image,
model management, the editing state's downloads, and that the port never
imports JAX."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.core import edit as jedit
from wgpu_3dgs_viewer_app_tpu.viewer import Viewer as JViewer
from wgpu_3dgs_viewer_app_tpu_torch.app.cli import main as cli_main
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.core import edit as tedit
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, read_ply, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.utils.png import read_png, write_png
from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer, Viewer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply")
GOLDEN = os.path.join(REPO, "tests", "golden", "golden_256.png")


def _golden_scene():
    """The golden fixture: first 20k records, orbit camera at yaw 30."""
    g = read_ply(FIXTURE)
    g = g.select(np.arange(g.count) < 20_000)
    center = g.center()
    dist = float(np.abs(g.pos - center).max()) * 2.0
    yaw = math.radians(30.0)
    pos = center + dist * np.array([math.sin(yaw), 0.3, math.cos(yaw)], np.float32)
    return g, center, pos


def _u8(img):
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8).astype(np.int16)


def test_viewer_render_matches_jax_viewer():
    """The golden fixture's first 10k splats at 128x128 (golden camera):
    the port's Viewer.render (plain path) against the JAX Viewer.render on
    the CPU, held to the golden gate."""
    g, center, pos = _golden_scene()
    g = g.select(np.arange(g.count) < 10_000)
    ref = JViewer(g, 128, 128, max_dup=16).render(JCamera(target=center, pos=pos))
    got = Viewer(g, 128, 128, max_dup=16, device="cpu").render(
        CameraOrbitControl(target=center, pos=pos))
    assert got.shape == (128, 128, 3) and got.dtype == torch.float32
    assert float(got.amax(dim=-1).gt(0.02).float().mean()) > 0.1
    assert_golden_close(_u8(got.numpy()), _u8(ref))


def _edit_state(v, edit_mod, n, with_mask=True):
    """The same editing state on a JAX or a port viewer, from numpy seeds:
    a committed edit on one selection, then a live selection edit and
    highlight on another, and (optionally) a mask."""
    rng = np.random.default_rng(12)
    first, second = rng.random(n) < 0.4, rng.random(n) < 0.3
    mask = rng.random(n) < 0.8
    b = v.models["model"].buffers
    b.set_selection(first.astype(np.uint8))
    b.commit_selection_edit(edit_mod.EDIT_FLAG_ENABLED | edit_mod.EDIT_FLAG_OVERRIDE_COLOR,
                            (0.2, 0.9, 0.3), (0.1, 0.3, 1.2, 0.7))
    b.set_selection(second.astype(np.uint8))
    v.update_selection_edit(edit_mod.GaussianEditPod(edit_mod.EDIT_FLAG_ENABLED, (0.15, 1.2, 1.0),
                                                     0.1, 0.2, 1.0, 0.9))
    v.update_selection_highlight(edit_mod.SelectionHighlightPod((1.0, 0.0, 1.0, 0.4)), True)
    if with_mask:
        b.set_mask(mask.astype(np.uint8))
    return b


def _edit_scene():
    g = make_random_scene(1000, seed=13, extent=1.5, scale_range=(0.008, 0.03))
    return g, dict(target=(0, 0, 0), pos=(0.4, 0.3, -4.5))


def test_viewer_gated_frame_matches_jax_viewer():
    """Selection edit + highlight, committed edits and a mask at 128x128,
    tile 16: the port's plain path against the JAX viewer's XLA path
    (`use_pallas=False`) with the same state, held to the golden gate; the
    edited frame differs from the unedited one."""
    g, cam = _edit_scene()
    jv = JViewer(g, 128, 128, tile=16, max_dup=8, use_pallas=False)
    _edit_state(jv, jedit, g.count)
    ref = np.asarray(jv.render(JCamera(**cam)))
    tv = Viewer(g, 128, 128, tile=16, max_dup=8, device="cpu")
    _edit_state(tv, tedit, g.count)
    got = tv.render(CameraOrbitControl(**cam))
    assert_golden_close(_u8(got.numpy()), _u8(ref))
    plain = Viewer(g, 128, 128, tile=16, max_dup=8, device="cpu").render(CameraOrbitControl(**cam))
    assert float((got - plain).abs().max()) > 0.1


def test_show_unedited_equals_ungated_frame():
    """`show_unedited` drops the committed and the live selection edit; with
    no mask and the highlight off it is the ungated frame, bit for bit."""
    g, cam = _edit_scene()
    v = Viewer(g, 64, 64, tile=16, max_dup=8, device="cpu")
    _edit_state(v, tedit, g.count, with_mask=False)
    v.update_selection_highlight(v.highlight, show=False)
    edited = v.render(CameraOrbitControl(**cam))
    unedited = v.render(show_unedited=True)
    plain = Viewer(g, 64, 64, tile=16, max_dup=8, device="cpu").render(CameraOrbitControl(**cam))
    assert torch.equal(unedited, plain)
    assert not torch.equal(edited, plain)


def test_commit_and_downloads_match_jax_buffers():
    """The editing state's downloads (edits, selection, mask) equal the JAX
    buffers' after the same operations."""
    g, _ = _edit_scene()
    jv = JViewer(g, 64, 64, use_pallas=False)
    tv = Viewer(g, 64, 64, device="cpu")
    jb, tb = _edit_state(jv, jedit, g.count), _edit_state(tv, tedit, g.count)
    for a, b in zip(jb.download_edits(), tb.download_edits()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jb.download_selection(), tb.download_selection())
    assert np.array_equal(jb.download_mask(), tb.download_mask())
    assert tb.edit_flags.dtype == torch.int32 and tb.mask is not None
    # A model never edited holds no gate tensors; its downloads are the defaults.
    fresh = Viewer(g, 64, 64, device="cpu").models["model"].buffers
    assert fresh.edit_flags is None and fresh.selection is None and fresh.mask is None
    for a, b in zip(jv.models["model"].buffers.download_edits(), fresh.download_edits()):
        assert a.dtype == b.dtype
    assert np.array_equal(fresh.download_mask(), np.ones(g.count, np.uint8))
    assert np.array_equal(fresh.download_selection(), np.zeros(g.count, np.uint8))


def test_cli_render_golden_cpu(tmp_path):
    """The port's CLI `render --device cpu` on the golden fixture passes the
    gate against tests/golden/golden_256.png (scripts/gen_golden.py knobs)."""
    g, _, _ = _golden_scene()
    ply, out = str(tmp_path / "golden_20k.ply"), str(tmp_path / "render.png")
    with open(ply, "wb") as f:
        write_ply(f, g)
    rc = cli_main(["render", ply, "-o", out, "--width", "256", "--height", "256",
                   "--max-dup", "16", "--orbit", "30", "--device", "cpu"])
    assert rc == 0
    assert_golden_close(read_png(out).astype(np.int16), read_png(GOLDEN).astype(np.int16))


def test_png_roundtrip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (17, 23, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), img)
    assert np.array_equal(read_png(str(tmp_path / "a.png")), img)


def test_model_management_and_unported_paths():
    v = MultiModelViewer(64, 48, device="cpu")
    bg = v.render(CameraOrbitControl(pos=(0, 0, -4)))
    assert bg.shape == (48, 64, 3) and float(bg.abs().max()) == 0.0  # no models: background
    g = make_random_scene(200, seed=0, extent=1.0)
    assert v.add_model("m", g).file_name == "m"
    assert v.add_model("m", g).file_name == "m (1)"
    assert len(v.model_order()) == 2
    both = v.render()  # two visible models: the merged frame (rank in the key)
    assert both.shape == (48, 64, 3) and bool(torch.isfinite(both).all())
    v.models["m (1)"].visible = False
    img = v.render()
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0.05
    # The same model twice: the nearer copy hides most of the farther one.
    assert float((both - img).abs().max()) < 0.5 and float(both.max()) > 0.05
    v.remove_model("m (1)")
    with pytest.raises(ValueError):
        v.remove_model("m")


def test_port_never_imports_jax():
    """Importing every module of the port leaves `jax` out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wgpu_3dgs_viewer_app_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'wgpu_3dgs_viewer_app_tpu')"
        " or m.startswith(('jax.', 'jaxlib', 'wgpu_3dgs_viewer_app_tpu.')))\n"
        "assert len(names) > 20, names\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
