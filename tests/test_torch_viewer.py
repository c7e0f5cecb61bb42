"""The port's whole slice on the CPU: `Viewer.render` against the JAX
viewer, the CLI against the committed golden image, model management, and
that the port never imports JAX."""

import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.viewer import Viewer as JViewer
from wgpu_3dgs_viewer_app_tpu_torch.app.cli import main as cli_main
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
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
    """20k splats at 256x256: the port's Viewer.render (plain path) against
    the JAX Viewer.render on the CPU, held to the golden gate."""
    g, center, pos = _golden_scene()
    ref = JViewer(g, 256, 256, max_dup=16).render(JCamera(target=center, pos=pos))
    got = Viewer(g, 256, 256, max_dup=16, device="cpu").render(
        CameraOrbitControl(target=center, pos=pos))
    assert got.shape == (256, 256, 3) and got.dtype == torch.float32
    assert_golden_close(_u8(got.numpy()), _u8(ref))


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
    with pytest.raises(NotImplementedError, match="multi-model"):
        v.render()
    v.models["m (1)"].visible = False
    img = v.render()
    assert img.shape == (48, 64, 3) and bool(torch.isfinite(img).all())
    assert float(img.max()) > 0.05
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
