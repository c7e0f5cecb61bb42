"""The port's v1 chain (the unquantized tile-list path) against the JAX
package's: `build_tile_lists` and `build_entry_planes` bit for bit on the
same carried-over `PreprocessOut`, the plain v1 compositor (plain version
of kernel K6) against `composite_tiles_jnp` and the Pallas kernel in
interpret mode on the same `EntryPlanes`, the whole chain from pods against
the JAX chain and against the brute-force oracle, and the `convert`
helpers that carry the chain's state across."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.data import Compressions as JCompressions
from wgpu_3dgs_viewer_app_tpu.data import Cov3dCompression as JCov
from wgpu_3dgs_viewer_app_tpu.data import ShCompression as JSh
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene as jscene
from wgpu_3dgs_viewer_app_tpu.data import pack_gaussians as jpack
from wgpu_3dgs_viewer_app_tpu.ops import TileConfig as JTileConfig
from wgpu_3dgs_viewer_app_tpu.ops import build_entry_planes as jbuild_entry_planes
from wgpu_3dgs_viewer_app_tpu.ops import build_tile_lists as jbuild_tile_lists
from wgpu_3dgs_viewer_app_tpu.ops import composite_tiles_jnp, composite_tiles_pallas
from wgpu_3dgs_viewer_app_tpu.ops import preprocess as jpreprocess
from wgpu_3dgs_viewer_app_tpu_torch import convert
from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions, Cov3dCompression, ShCompression
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    PLANE_FIELDS, TileConfig, build_entry_planes, build_tile_lists, composite_tiles,
    composite_tiles_plain, kernels, preprocess)
from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import EntryPlanes
from wgpu_3dgs_viewer_app_tpu_torch.ops.rasterize_ref import rasterize_reference

FULL = (JSh.SINGLE, JCov.SINGLE)
PORT_FULL = Compressions(ShCompression.SINGLE, Cov3dCompression.SINGLE)
# The reference's own tolerance for its jnp and Pallas compositors
# (tests/test_pipeline.py).
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _jax_scene(n, w, h, sh_degree=3, mode=0, seed=0):
    """The JAX test pipeline's scene (tests/test_pipeline.py::setup_scene):
    (JAX pod as numpy, view, proj, JAX PreprocessOut)."""
    comp = JCompressions(*FULL)
    pod = {k: np.asarray(v) for k, v in jpack(jscene(n, seed=seed, extent=1.0,
                                                     scale_range=(0.02, 0.1)), comp).items()}
    cam = JCamera(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = cam.view(), cam.projection(w / h)
    pre = jpreprocess({k: jnp.asarray(v) for k, v in pod.items()}, comp, jnp.asarray(view),
                      jnp.asarray(proj), jnp.eye(4), w, h, sh_degree=sh_degree,
                      display_mode=mode)
    return pod, view, proj, pre


@functools.lru_cache(maxsize=None)
def _jax_chain(n, w, h, d, sh_degree=3, mode=0):
    """The JAX v1 chain on that scene: (PreprocessOut, TileLists, EntryPlanes)."""
    pre = _jax_scene(n, w, h, sh_degree, mode)[3]
    cfg = JTileConfig(w, h, tile=16, max_dup=d)
    lists = jbuild_tile_lists(pre, cfg)
    return pre, lists, jbuild_entry_planes(pre, lists, cfg)


def _pre_np(jpre) -> dict:
    return {f.name: np.asarray(getattr(jpre, f.name)) for f in dataclasses.fields(jpre)}


CHAINS = [(512, 128, 128, 16), (512, 128, 128, 4), (300, 100, 76, 16)]
CHAIN_IDS = ["d16", "d4", "100x76"]


@pytest.mark.parametrize("n,w,h,d", CHAINS, ids=CHAIN_IDS)
def test_tile_lists_match_jax(n, w, h, d):
    """Same PreprocessOut: the live sorted keys and splat indices, the tile
    ranges and the live count bit-equal to the JAX `TileLists`."""
    jpre, jl, _ = _jax_chain(n, w, h, d)
    cfg = TileConfig(w, h, tile=16, max_dup=d)
    assert cfg.depth_bits == JTileConfig(w, h, tile=16, max_dup=d).depth_bits
    lists = build_tile_lists(convert.preprocess_out_from_jax(_pre_np(jpre)), cfg)
    nv = int(jl.n_valid)
    assert lists.n_valid == nv > n
    keys = lists.sorted_keys.numpy().view(np.uint32)
    assert np.array_equal(keys, np.asarray(jl.sorted_keys)[:nv])
    assert np.array_equal(lists.sorted_idx.numpy(), np.asarray(jl.sorted_idx)[:nv])
    assert np.array_equal(lists.tile_starts.numpy(), np.asarray(jl.tile_starts))
    assert np.array_equal(lists.tile_counts.numpy(), np.asarray(jl.tile_counts))
    if d == 4:  # some splats' rects hold more than 4 tiles: the cap is exercised
        assert nv < int(_jax_chain(n, w, h, 16)[1].n_valid)


@pytest.mark.parametrize("n,w,h,d", CHAINS, ids=CHAIN_IDS)
def test_entry_planes_match_jax(n, w, h, d):
    """Same PreprocessOut and TileLists: equal row starts and tile counts,
    and every row a tile owns bit-equal on all nine planes (the port sizes
    R by the live count, the reference by all N * D slots)."""
    jpre, jl, jp = _jax_chain(n, w, h, d)
    cfg = TileConfig(w, h, tile=16, max_dup=d)
    pre = convert.preprocess_out_from_jax(_pre_np(jpre))
    lists = convert.tile_lists_from_jax(jl.sorted_idx, jl.sorted_keys, jl.tile_starts,
                                        jl.tile_counts, jl.n_valid)
    planes = build_entry_planes(pre, lists, cfg)
    assert np.array_equal(planes.row_starts.numpy(), np.asarray(jp.row_starts))
    assert np.array_equal(planes.tile_counts.numpy(), np.asarray(jp.tile_counts))
    owned = int(((np.asarray(jp.tile_counts) + 127) // 128).sum())
    assert planes.ent.shape[1] >= owned and planes.ent.shape[0] == len(PLANE_FIELDS)
    assert np.array_equal(planes.ent.numpy()[:, :owned].view(np.uint32),
                          np.asarray(jp.ent)[:, :owned].view(np.uint32))
    # Padding slots are exact no-ops: zero alpha.
    alpha = planes.ent[PLANE_FIELDS.index("alpha")].reshape(-1)
    assert int((alpha != 0).sum()) <= lists.n_valid


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_composite_plain_matches_jnp(mode):
    """The plain v1 compositor against `composite_tiles_jnp` on the same
    EntryPlanes, in the three display modes."""
    _, _, jp = _jax_chain(300, 96, 96, 16, sh_degree=0, mode=mode)
    cfg = TileConfig(96, 96, tile=16, max_dup=16)
    ref = np.asarray(composite_tiles_jnp(jp, JTileConfig(96, 96, tile=16, max_dup=16),
                                         flat_mode=mode != 0))
    planes = convert.entry_planes_from_jax(jp.ent, jp.row_starts, jp.tile_counts)
    got = composite_tiles(planes, cfg, flat_mode=mode != 0).numpy()
    assert got.shape == ref.shape == (96, 96, 4)
    assert got[..., 3].mean() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_composite_plain_matches_pallas_interpret():
    """The plain v1 compositor against the JAX Pallas kernel (the TPU
    kernel K6 replaces) in interpret mode, at the reference test's shapes."""
    _, _, jp = _jax_chain(256, 64, 64, 16, sh_degree=1)
    ref = np.asarray(composite_tiles_pallas(jp, JTileConfig(64, 64, tile=16, max_dup=16),
                                            interpret=True))
    planes = convert.entry_planes_from_jax(jp.ent, jp.row_starts, jp.tile_counts)
    before = dict(kernels.LAUNCHES)
    got = composite_tiles_plain(planes, TileConfig(64, 64, tile=16, max_dup=16)).numpy()
    assert kernels.LAUNCHES == before
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_composite_plain_counts_rows_and_blends():
    """The plain v1 compositor's `stats` (K6's bound) on hand-made planes,
    32x32 in four 16x16 tiles, every entry with a zero conic (alpha = its
    opacity at every pixel): tile 0 has 3 rows at 0.99 and exits after its
    first row, having needed 2 entries a pixel (T 1, 0.01, then 1e-4 <=
    1/255); tile 1 has 200 entries at 0 (2 rows, all needed); tile 2 none;
    tile 3 50 entries at 0.01 (1 row, all needed). `walked`: each tile's
    rows."""
    counts, row_starts, ops = [384, 200, 0, 50], [0, 3, 5, 5], [0.99, 0.0, 0.0, 0.01]
    ent = torch.zeros((len(PLANE_FIELDS), 6, 128))
    flat = ent.view(len(PLANE_FIELDS), -1)
    for s, n, op in zip(row_starts, counts, ops):
        flat[PLANE_FIELDS.index("alpha"), s * 128:s * 128 + n] = op
        flat[PLANE_FIELDS.index("r"), s * 128:s * 128 + n] = 1.0
    planes = EntryPlanes(ent, torch.tensor(row_starts, dtype=torch.int32),
                         torch.tensor(counts, dtype=torch.int32))
    stats = {}
    img = composite_tiles_plain(planes, TileConfig(32, 32, tile=16, max_dup=4), stats=stats)
    walked = stats.pop("walked")
    assert stats == {"rows": 1 + 2 + 0 + 1, "pairs": 256 * (2 + 200 + 50)}
    assert walked.tolist() == [1, 2, 0, 1]
    assert bool((img[:16, :16, 3] == 1.0).all()) and not bool(img[:16, 16:].any())


def _port_chain(n, w, h, d, sh_degree=3):
    pod, view, proj, _ = _jax_scene(n, w, h, sh_degree)
    pre = preprocess(convert.pod_from_jax(pod, PORT_FULL), PORT_FULL, view, proj,
                     np.eye(4, dtype=np.float32), w, h, sh_degree=sh_degree)
    cfg = TileConfig(w, h, tile=16, max_dup=d)
    return pre, composite_tiles(build_entry_planes(pre, build_tile_lists(pre, cfg), cfg), cfg)


def test_v1_chain_from_pods_matches_jax():
    """Pods -> preprocess -> build_tile_lists -> build_entry_planes ->
    composite_tiles, port against JAX, under the golden gate (the two
    preprocesses may round a transcendental an ulp apart, which moves an
    f32 depth key)."""
    _, img = _port_chain(512, 128, 128, 16)
    jpre, jl, jp = _jax_chain(512, 128, 128, 16)
    ref = np.asarray(composite_tiles_jnp(jp, JTileConfig(128, 128, tile=16, max_dup=16)))
    to_u8 = lambda x: np.clip(np.asarray(x) * 255.0, 0, 255).astype(np.int16)  # noqa: E731
    assert img.numpy()[..., 3].mean() > 0.2
    assert_golden_close(to_u8(img.numpy()), to_u8(ref))


def test_v1_chain_matches_oracle():
    """The port's v1 chain against the port's brute-force oracle (exact
    depth order, no tiling), at the reference test's limits."""
    pre, img = _port_chain(512, 128, 128, 16)
    d = np.abs(img.numpy() - rasterize_reference(pre, 128, 128).numpy())
    assert d.mean() < 2e-3
    assert d.max() < 0.05


def test_v1_chain_empty_scene_renders_blank():
    """Every splat outside the frustum: no live slot, a blank image (as the
    reference's `test_empty_scene_renders_blank`)."""
    g = jscene(64, seed=0, extent=1.0)
    g.pos[:] += 1000.0
    pod = {k: np.asarray(v) for k, v in jpack(g, JCompressions(*FULL)).items()}
    cam = JCamera(target=(0, 0, 0), pos=(0, 0, -4))
    pre = preprocess(convert.pod_from_jax(pod, PORT_FULL), PORT_FULL, cam.view(),
                     cam.projection(1.0), np.eye(4, dtype=np.float32), 64, 64)
    assert not bool(pre.valid.any())
    cfg = TileConfig(64, 64, tile=16)
    lists = build_tile_lists(pre, cfg)
    assert lists.n_valid == 0 and int(lists.tile_counts.sum()) == 0
    img = composite_tiles(build_entry_planes(pre, lists, cfg), cfg)
    assert img.shape == (64, 64, 4) and not bool(img.any())


def test_convert_roundtrip():
    """The convert helpers carry the JAX v1 state across bit for bit (the
    TileLists as its live prefix) and refuse a malformed plane tensor."""
    jpre, jl, jp = _jax_chain(512, 128, 128, 4)
    pre_np = _pre_np(jpre)
    pre = convert.preprocess_out_from_jax(pre_np)
    for name, v in pre_np.items():
        got = getattr(pre, name).numpy()
        assert got.dtype == v.dtype and np.array_equal(got.view(np.uint8), v.view(np.uint8)), name
    lists = convert.tile_lists_from_jax(jl.sorted_idx, jl.sorted_keys, jl.tile_starts,
                                        jl.tile_counts, jl.n_valid)
    nv = int(jl.n_valid)
    assert lists.n_valid == nv and lists.sorted_keys.dtype == torch.int32
    keys = lists.sorted_keys.numpy().view(np.uint32)
    assert np.array_equal(keys, np.asarray(jl.sorted_keys)[:nv])
    assert np.array_equal(lists.sorted_idx.numpy(), np.asarray(jl.sorted_idx)[:nv])
    planes = convert.entry_planes_from_jax(jp.ent, jp.row_starts, jp.tile_counts)
    assert np.array_equal(planes.ent.numpy().view(np.uint32), np.asarray(jp.ent).view(np.uint32))
    assert np.array_equal(planes.row_starts.numpy(), np.asarray(jp.row_starts))
    with pytest.raises(ValueError, match="ent"):
        convert.entry_planes_from_jax(np.asarray(jp.ent)[:8], jp.row_starts, jp.tile_counts)
