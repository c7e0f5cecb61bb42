"""Port compositor (plain version of kernel K3) against the JAX Pallas
compositor in interpret mode on the same sorted entries, and the port's
tiled pipeline against its brute-force oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops.composite import composite_tiles_pallas_v2
from wgpu_3dgs_viewer_app_tpu_torch.convert import sorted_entries_from_jax, sorted_entries_to_jax
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.data import (
    Compressions, flat_pod_to_words, make_random_scene, pack_gaussians, pod_to_tensors)
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    TileConfig, build_sorted_entries_fused, composite_tiles_v2, preprocess)
from wgpu_3dgs_viewer_app_tpu_torch.ops.rasterize_ref import rasterize_reference

# The reference stops at 128-entry chunks; any other early-exit point
# differs by at most the remaining transmittance, 1/255 a channel.
TOL = 1.0 / 255.0 + 1e-5


def _entries(n, w, h, tile, max_dup, mode=0, seed=0, device="cpu", extent=1.2,
             scale_range=(0.01, 0.06)):
    comp = Compressions()
    g = make_random_scene(n, seed=seed, extent=extent, scale_range=scale_range)
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), device)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.2, 0.3, -3.5))
    cfg = TileConfig(w, h, tile=tile, max_dup=max_dup)
    view, proj = cam.view(), cam.projection(w / h)
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, np.eye(4, dtype=np.float32),
                                    display_mode=mode)
    return se, cfg, (pod, comp, view, proj)


@pytest.mark.parametrize("tile,flat", [(32, False), (16, True), (32, True)])
def test_composite_matches_jax_kernel(tile, flat):
    """Same sorted entries through the port's plain compositor and the JAX
    Pallas compositor (interpret mode): max abs <= 1/255 + 1e-5."""
    se, cfg, _ = _entries(3000, 128, 96, tile, 8, mode=2 if flat else 0)
    assert se.n_valid > 3000
    planes, starts, counts, n_valid = sorted_entries_to_jax(se)
    jse = jbin.SortedEntries(jnp.asarray(planes), jnp.asarray(starts), jnp.asarray(counts),
                             jnp.asarray(n_valid))
    jcfg = jbin.TileConfig(cfg.width, cfg.height, tile=tile, max_dup=8)
    ref = np.asarray(composite_tiles_pallas_v2(jse, jcfg, flat_mode=flat, interpret=True))
    got = composite_tiles_v2(se, cfg, flat_mode=flat).numpy()
    assert got.shape == ref.shape == (96, 128, 4)
    assert np.abs(got - ref).max() <= TOL
    assert got[..., 3].mean() > 0.2  # the frame is well covered


def test_sorted_entries_roundtrip():
    se, _, _ = _entries(500, 64, 64, 16, 4)
    back = sorted_entries_from_jax(*sorted_entries_to_jax(se))
    assert back.n_valid == se.n_valid
    assert torch.equal(back.entries[: se.n_valid], se.entries)
    assert torch.equal(back.tile_starts, se.tile_starts)
    assert torch.equal(back.tile_counts, se.tile_counts)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_tiled_pipeline_matches_oracle(mode):
    """Front-end + sort + compositor vs the brute-force per-pixel oracle
    (exact depth order, no quantisation), with the JAX package's bounds: a
    max bound in splat mode only, since a flat fill's hard 2-sigma edge
    flips whole boundary pixels under the f16 conic."""
    se, cfg, (pod, comp, view, proj) = _entries(300, 96, 96, 16, 16, mode=mode, seed=1,
                                                extent=1.0, scale_range=(0.02, 0.1))
    img = composite_tiles_v2(se, cfg, flat_mode=mode != 0).numpy()
    pre = preprocess(pod, comp, view, proj, np.eye(4, dtype=np.float32), 96, 96,
                     display_mode=mode)
    ref = rasterize_reference(pre, 96, 96, flat_mode=mode != 0).numpy()
    d = np.abs(img - ref)
    assert d.mean() < (4e-3 if mode == 0 else 2e-3), d.mean()
    if mode == 0:
        assert d.max() < 0.08, d.max()
