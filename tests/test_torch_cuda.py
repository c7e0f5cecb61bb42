"""Card tests: each hand-written CUDA kernel against its plain torch version
on the same CUDA tensors, and the whole slice on the card against the CPU.

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports neither JAX nor the JAX package, so it also runs on a machine
without JAX (from the repo root):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import math
import os

import numpy as np
import pytest
import torch

from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.data import (
    ALL_COMPRESSIONS, flat_pod_to_words, make_random_scene, pack_gaussians, pod_to_tensors,
    read_ply)
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    SENTINEL, TileConfig, build_sorted_entries_fused, composite_tiles_plain_v2,
    composite_tiles_v2, enumerate_entries_fused, enumerate_entries_plain, kernels,
    sort_entries, sort_entries_plain)
from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries, compare_sorted
from wgpu_3dgs_viewer_app_tpu_torch.viewer import Viewer

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The plain compositor stops at 128-entry chunks, the kernel per 256-entry
# batch: they differ by at most the remaining transmittance.
K3_TOL = 1.0 / 255.0 + 1e-5
EYE = np.eye(4, dtype=np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pod(comp, n, dev, seed=0, extent=2.0, scale_range=(0.004, 0.05)):
    g = make_random_scene(n, seed=seed, extent=extent, scale_range=scale_range)
    return pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), dev)


def _camera(w, h, pos=(0.3, 0.2, -6.0)):
    cam = CameraOrbitControl(target=(0, 0, 0), pos=pos)
    return cam.view(), cam.projection(w / h)


@pytest.mark.parametrize("ci", range(8), ids=lambda i: f"{ALL_COMPRESSIONS[i].sh.value}-"
                                                      f"{ALL_COMPRESSIONS[i].cov3d.value}")
@pytest.mark.parametrize("deg,mode,d", [(3, 0, 4), (1, 1, 8), (0, 2, 4), (2, 0, 16)])
def test_frontend_kernel_matches_plain(dev, ci, deg, mode, d):
    """K1 vs plain preprocess + enumerate: all compressions, SH 0-3, the
    three display modes, several max_dup."""
    comp = ALL_COMPRESSIONS[ci]
    pod = _pod(comp, 20000, dev, seed=ci)
    cfg = TileConfig(1920, 1080, tile=32, max_dup=d)
    view, proj = _camera(1920, 1080)
    before = kernels.LAUNCHES["fused"]
    got = enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, sh_degree=deg,
                                  display_mode=mode)
    assert kernels.LAUNCHES["fused"] == before + 1
    ref = enumerate_entries_plain(pod, comp, cfg, view, proj, EYE, sh_degree=deg,
                                  display_mode=mode)
    stats = compare_entries(got, ref, cfg)
    assert stats["live_a"] > 1000, stats


def _entries(e, frac, cfg, seed):
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, cfg.n_tiles, e, dtype=np.uint64)
    low = rng.integers(0, 1 << 10, e, dtype=np.uint64)
    keys = ((tiles << np.uint64(cfg._tile_shift)) | low).astype(np.uint32)
    keys[rng.random(e) < frac] = SENTINEL
    pay = rng.integers(0, 2**32, (e, 3), dtype=np.uint64).astype(np.uint32)
    return np.ascontiguousarray(np.concatenate([keys[:, None], pay], axis=1)).view(np.int32)


@pytest.mark.parametrize("e,frac", [(0, 0.0), (777, 1.0), (1, 0.0), (2049, 0.5), (65536, 0.44),
                                    (1 << 20, 0.0), (3_000_001, 0.44)])
def test_sort_kernel_matches_plain(dev, e, frac):
    """K2 vs torch.sort + gather: sorted keys bit-equal, payload multisets
    and tile ranges equal. 1080p at 16-px tiles puts bit 31 in many keys."""
    cfg = TileConfig(1920, 1080, tile=16, max_dup=4)
    ent = torch.from_numpy(_entries(e, frac, cfg, seed=e)).to(dev)
    before = kernels.LAUNCHES["sort"]
    got = sort_entries(ent, cfg)
    assert kernels.LAUNCHES["sort"] == before + 1
    compare_sorted(got, sort_entries_plain(ent, cfg))


@pytest.mark.parametrize("tile,mode", [(32, 0), (16, 0), (32, 1), (32, 2)])
def test_composite_kernel_matches_plain(dev, tile, mode):
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 50000, dev)
    cfg = TileConfig(1920, 1080, tile=tile, max_dup=4)
    view, proj = _camera(1920, 1080)
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE, display_mode=mode)
    before = kernels.LAUNCHES["composite"]
    got = composite_tiles_v2(se, cfg, flat_mode=mode != 0)
    assert kernels.LAUNCHES["composite"] == before + 1
    ref = composite_tiles_plain_v2(se, cfg, flat_mode=mode != 0)
    assert float(got[..., 3].mean()) > 0.05
    assert float((got - ref).abs().max()) <= K3_TOL


def test_wrappers_reject_bad_inputs(dev):
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 1000, dev)
    cfg = TileConfig(256, 256, tile=32, max_dup=4)
    view, proj = _camera(256, 256)
    bad = dict(pod, pos=pod["pos"].double())
    with pytest.raises(ValueError, match="pos"):
        enumerate_entries_fused(bad, comp, cfg, view, proj, EYE)
    with pytest.raises(ValueError, match="entries"):
        sort_entries(torch.zeros((10, 3), dtype=torch.int32, device=dev), cfg)
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE)
    with pytest.raises(ValueError):
        composite_tiles_v2(se, TileConfig(256, 256, tile=64, max_dup=4))


def test_viewer_on_card_matches_cpu(dev):
    """The golden scene through the kernels on the card vs the plain path
    on the CPU."""
    g = read_ply(os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply"))
    g = g.select(np.arange(g.count) < 20_000)
    center = g.center()
    dist = float(np.abs(g.pos - center).max()) * 2.0
    yaw = math.radians(30.0)
    cam = CameraOrbitControl(target=center, pos=center + dist * np.array(
        [math.sin(yaw), 0.3, math.cos(yaw)], np.float32))
    kernels.reset_launch_counts()
    got = Viewer(g, 256, 256, max_dup=16, device=dev).render(cam)
    assert kernels.LAUNCHES == {"fused": 1, "sort": 1, "composite": 1}
    ref = Viewer(g, 256, 256, max_dup=16, device="cpu").render(cam)
    # CPU and card transcendentals may move a depth key by one step, which
    # can reorder near-ties: hold the two to the golden gate.
    assert_golden_close(_u8(got.cpu()), _u8(ref))


def _u8(img):
    return np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8).astype(np.int16)
