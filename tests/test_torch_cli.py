"""The port's first-person camera, CLI (`render --frames`, `serve`) and web
assets against the JAX package's.

Held: the first-person control's pose, vectors and matrices within 1e-6 of
JAX's `core/camera.py` through the same conversions and moves; the CLI's
orbit sequence within the golden gate of the JAX CLI's, each of its frames
byte for byte the single render at that yaw; `serve` building its session
on the device asked for (and refusing CUDA without a card); the assets
equal to JAX's once the product name (TPU -> GPU) and the service-worker
cache name are swapped."""

import math

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu.app import server as jserver
from wgpu_3dgs_viewer_app_tpu.app.cli import main as jax_cli
from wgpu_3dgs_viewer_app_tpu.core import camera as jcam
from wgpu_3dgs_viewer_app_tpu_torch.app import server
from wgpu_3dgs_viewer_app_tpu_torch.app.cli import main as cli
from wgpu_3dgs_viewer_app_tpu_torch.core import camera as tcam
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.utils.png import read_png

# Both packages compute the camera in numpy f32 by the same steps.
CAMERA_TOL = 1e-6


def _same_fp(t, j):
    assert isinstance(t, tcam.CameraFirstPersonControl)
    assert (t.yaw, t.pitch, t.z_near, t.z_far, t.vertical_fov) == pytest.approx(
        (j.yaw, j.pitch, j.z_near, j.z_far, j.vertical_fov), abs=CAMERA_TOL)
    for a, b in ((t.pos, j.pos), (t.get_forward(), j.get_forward()),
                 (t.get_right(), j.get_right()), (t.view(), j.view()),
                 (t.projection(1.5), j.projection(1.5))):
        np.testing.assert_allclose(a, b, rtol=0, atol=CAMERA_TOL)


@pytest.mark.parametrize("pose", [((0, 0, 0), (0, 0, -1)), ((0.3, -0.2, 0.5), (2.0, 1.5, -3.0)),
                                  ((1, 2, 3), (1.0, 9.0, 3.5))])
def test_first_person_camera_matches_jax(pose):
    target, pos = pose
    jo = jcam.CameraOrbitControl(target=target, pos=pos, z=(0.05, 500.0),
                                 vertical_fov=math.radians(50.0))
    to = tcam.CameraOrbitControl(target=target, pos=pos, z=(0.05, 500.0),
                                 vertical_fov=math.radians(50.0))
    jf, tf = jcam.to_first_person(jo), tcam.to_first_person(to)
    _same_fp(tf, jf)
    assert tcam.to_first_person(tf) is tf
    # Yaw wraps at 2 pi; pitch clamps short of the poles.
    for dy, dp in ((0.4, -0.2), (7.0, 3.0), (-2.5, -4.0), (0.01, 0.9)):
        jf.yaw_by(dy)
        jf.pitch_by(dp)
        tf.yaw_by(dy)
        tf.pitch_by(dp)
        _same_fp(tf, jf)
    assert abs(tf.pitch) < math.pi / 2 and 0 <= tf.yaw < 2 * math.pi
    jf.pos = jf.pos + np.array([0.5, -0.1, 0.2], np.float32)
    tf.pos = tf.pos + np.array([0.5, -0.1, 0.2], np.float32)
    for arm in (1.0, 2.5):
        jb, tb = jcam.to_orbit(jf, arm), tcam.to_orbit(tf, arm)
        assert isinstance(tb, tcam.CameraOrbitControl) and tcam.to_orbit(tb, 3.0) is tb
        for a, b in ((tb.target, jb.target), (tb.pos, jb.pos), (tb.view(), jb.view()),
                     (tb.projection(0.75), jb.projection(0.75))):
            np.testing.assert_allclose(a, b, rtol=0, atol=CAMERA_TOL)
        # And back: the pose survives the round trip.
        _same_fp(tcam.to_first_person(tb), jcam.to_first_person(jb))
    with pytest.raises(TypeError):
        tcam.to_orbit(tcam.CameraTrait(), 1.0)


def _scene(tmp_path, n=150):
    ply = tmp_path / "m.ply"
    with open(ply, "wb") as f:
        write_ply(f, make_random_scene(n, seed=0, extent=0.5))
    return str(ply)


def test_cli_orbit_sequence_matches_jax(tmp_path):
    """`render --frames 3 --orbit-step 20`: an indexed sequence, each frame
    the single render at its yaw byte for byte, all within the golden gate
    of the JAX CLI's sequence."""
    ply = _scene(tmp_path)
    args = ["render", ply, "--width", "64", "--height", "64", "--sh-deg", "0", "--distance", "3"]
    seq = ["--frames", "3", "--orbit-step", "20"]
    assert cli(args + ["-o", str(tmp_path / "t.png"), "--device", "cpu"] + seq) == 0
    assert jax_cli(["--platform", "cpu"] + args + ["-o", str(tmp_path / "j.png")] + seq) == 0
    frames = []
    for i in range(3):
        got = tmp_path / f"t_{i:03d}.png"
        single = tmp_path / f"single_{i}.png"
        assert cli(args + ["-o", str(single), "--device", "cpu", "--orbit", str(20 * i)]) == 0
        assert got.read_bytes() == single.read_bytes()
        img, ref = read_png(str(got)), read_png(str(tmp_path / f"j_{i:03d}.png"))
        assert_golden_close(img.astype(np.int16), ref.astype(np.int16))
        frames.append(img)
    assert not np.array_equal(frames[0], frames[1])  # the camera moved
    assert frames[0].max() > 20


def test_cli_serve_builds_the_session(tmp_path, monkeypatch):
    """`serve` streams its models into a session on the device asked for
    and hands it to the server; CUDA without a card exits 2."""
    ply = _scene(tmp_path, n=90)
    seen = {}
    monkeypatch.setattr(server, "serve", lambda session, host, port: seen.update(
        session=session, host=host, port=port))
    assert cli(["serve", ply, "--device", "cpu", "--width", "80", "--height", "48",
                "--port", "8123", "--sh-comp", "half"]) == 0
    s = seen["session"]
    assert (seen["host"], seen["port"]) == ("127.0.0.1", 8123)
    assert s.device == torch.device("cpu") and s.compressions.sh.value == "half"
    assert s.loader is None and len(s.viewer.models["m.ply"].buffers) == 90
    assert s.update().shape == (48, 80, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in ("serve", "render"):
        seen.clear()
        assert cli([cmd, ply, "--device", "cuda"]) == 2 and not seen


@pytest.mark.parametrize("name", ["index.html", "manifest.json", "sw.js"])
def test_assets_match_jax_with_names_swapped(name):
    ours = (server.ASSETS / name).read_text()
    ref = (jserver.ASSETS / name).read_text()
    assert "TPU" in ref or "tpu" in ref
    assert ours == ref.replace("TPU", "GPU").replace("gs3d-tpu-v1", "gs3d-gpu-v1")
