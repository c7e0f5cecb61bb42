"""The plain reference against the port's plain path on small seeded
scenes (20k splats, 256x256, on the CPU): frames, merged frames, mask and
selection bits, and the served JPEG's coefficients."""

import io

import numpy as np
import pytest
import torch

import _portbench_toy as toy
from harness import check, drive, reference, scene, spec

# The port packs with its compiled codec, the reference with numpy: colour
# and opacity bytes may differ by one step (1/255), the f16 covariance by
# one step in a few words; the plain compositors then agree to rounding.
MAX_GAP, MEAN_GAP = 0.02, 1e-4


@pytest.mark.parametrize("workload,mode", [("inria6m.orbit", "splat"),
                                           ("multi3x1m.orbit", "splat"),
                                           ("inria6m.orbit", "ellipse"),
                                           ("inria6m.orbit", "point")])
def test_frame_matches_port_plain_path(workload, mode):
    """Each display mode a configuration may state reaches both sides."""
    cell = toy.toy_cell(workload)
    cell.config["display_mode"] = mode
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    d = drive.make(cell, models, toy.SEED, "cpu", trace=False)
    R = reference.Reference(cell.config, models, "cpu")
    for i in (0, 50):
        d.step(i)
        snap = d.samples.items[-1]
        mx, _, mean, _ = check.image_gaps(snap["img"],
                                       R.frame(reference.camera_at(cell.config, snap["yaw"])))
        assert mx <= MAX_GAP and mean <= MEAN_GAP, (i, mx, mean)
        assert float(snap["img"].amax()) > 0.05  # the frame shows the scene


def test_session_bits_and_frame():
    cell = toy.toy_cell("inria6m.edit", gesture_every=2)
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    d = drive.make(cell, models, toy.SEED, "cpu", trace=False)
    assert 0.25 <= d.info["mask_kept_share"] <= 0.75
    for i in range(4):
        d.step(i)
    R = reference.Reference(cell.config, models, "cpu")
    numbers = {}
    check.judge_bits(R, cell, d.final_bits(), numbers)
    assert numbers == {"mask_bits_differ": 0, "sel_bits_differ": 0}
    assert int(d.final_bits()["selection"].sum()) > 0
    check.judge_frames(R, cell, d.samples.items, numbers)
    assert numbers["img_max_abs"] <= MAX_GAP and numbers["img_mean_abs"] <= MEAN_GAP


def test_display_mode_is_checked():
    cell = toy.toy_cell("inria6m.orbit")
    assert reference.display_mode(cell.config) == 0
    with pytest.raises(ValueError):
        reference.display_mode({**cell.config, "display_mode": "wireframe"})
    models = scene.make_models(cell.config, toy.SEED, "cpu")
    cell.config["display_mode"] = "wireframe"
    with pytest.raises(ValueError):
        drive.make(cell, models, toy.SEED, "cpu", trace=False)


def test_jpeg_coefficients_read_back():
    """The reference's coefficient stages and reader against the port's
    encoder: a frame's file reads back to the reference's coefficients."""
    from gsref.utils import jpeg, jpeg_decode
    from wgpu_3dgs_viewer_app_tpu_torch.utils import jpeg as port_jpeg

    rng = np.random.default_rng(3)
    for h, w in ((64, 80), (37, 53), (1088 // 8, 1920 // 8)):
        img = torch.from_numpy(rng.random((h, w, 3), dtype=np.float32))
        img[: h // 3] *= 0.05
        blob = port_jpeg.encode_frame(img, 85)
        ww, hh, sampling, got = jpeg_decode.decode_coefficients(blob)
        assert (ww, hh) == (w, h) and sampling == [(2, 2), (1, 1), (1, 1)]
        want = jpeg.coefficients(jpeg.frame_to_u8(img), 85).numpy()
        real = check.real_blocks(w, h)
        assert np.array_equal(got[real], want[real])
        assert not real.all() or (h % 16 == 0 and w % 16 == 0)


def test_ply_bytes_round_trip():
    from wgpu_3dgs_viewer_app_tpu_torch.data import read_ply

    cfg = {"scene": {"generator": "inria_like", "layout_seed": 0,
                     "models": [{"splats": 3000, "scene_scale": 4.0}]}}
    m = scene.make_models(cfg, toy.SEED, "cpu")[0]
    g = read_ply(io.BytesIO(spec.load("entries", "session").ply_bytes(m)))
    for k, v in m.items():
        assert np.array_equal(getattr(g, k), v), k


def test_scene_from_seed():
    cfg = {"scene": {"generator": "inria_like", "layout_seed": 0,
                     "models": [{"splats": 5000, "scene_scale": 4.0}]}}
    a = scene.make_models(cfg, 2**33 + 5, "cpu")[0]
    b = scene.make_models(cfg, 2**33 + 5, "cpu")[0]
    c = scene.make_models(cfg, 2**33 + 6, "cpu")[0]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["pos"], c["pos"])
    op = 1 / (1 + np.exp(-a["opacity"]))
    assert 0.5 < (op > 0.5).mean() < 0.75   # the near-opaque mode
    # The layout is the configuration's, not the seed's: the blobs' splats
    # sit at the same places for every seed.
    assert abs(np.median(a["pos"], axis=0) - np.median(c["pos"], axis=0)).max() < 0.2
    assert np.isfinite(a["scale"]).all() and (np.abs(np.linalg.norm(a["rot"], axis=1) - 1)
                                               < 1e-5).all()
