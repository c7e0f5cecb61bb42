"""The port's sharded renderer (`parallel/`) on gloo ranks on the CPU,
against the port's single-device frame and the JAX `render_sharded`.

Each rank count (1, 2, 4) is one spawn of that many processes joined
through a file in the test's temporary directory (`_torch_dist.py`); the
spawn renders every case of that count and the tests below read what each
rank saved. The JAX side runs here, on conftest's virtual CPU devices,
with the equal-split transport (`ragged=False`), as `tests/test_parallel.py`
runs it. The scene is that test's `setup` (768 splats, 64x64, tile 16,
max_dup 8), packed once by the port (the native codec where it builds);
the JAX pod is the same raw pod in its row layout.

Tolerances: at 1 rank the frame equals the single-device `render_frame`
bit for bit; at 2 and 4 ranks within EXIT_TOL, because the compositor's
early exit goes by 128-entry chunks of each slab's own entry array; against
JAX mean < 1e-3 and max < 0.05, the JAX test's own bounds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from _torch_dist import spawn_ranks
from wgpu_3dgs_viewer_app_tpu import parallel as jpar
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.ops import TileConfig as JTileConfig
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.data import (Compressions, flat_pod_to_words,
                                                 make_random_scene, pack_gaussians,
                                                 pod_to_tensors)
from wgpu_3dgs_viewer_app_tpu_torch.ops import (TileConfig, composite_tiles_v2,
                                                enumerate_entries_from_pre, over_background,
                                                preprocess, sort_entries)
from wgpu_3dgs_viewer_app_tpu_torch.parallel import make_mesh, shard_pod, slab_config
from wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded import (Mesh, _clamp_plan,
                                                                    shard_bounds)
from wgpu_3dgs_viewer_app_tpu_torch.viewer import render_frame

# An image whose tiles stop at their 128-entry chunk exits may lack up to
# the remaining transmittance, 1/255 a channel.
EXIT_TOL = 1.0 / 255.0 + 1e-5
EYE = np.eye(4, dtype=np.float32)
CFG = TileConfig(64, 64, tile=16, max_dup=8)
CFG48 = TileConfig(64, 48, tile=16, max_dup=8)
COMP = Compressions()


def _raw_pod(n, seed):
    g = make_random_scene(n, seed=seed, extent=1.0, scale_range=(0.02, 0.08))
    return pack_gaussians(g, COMP)


@pytest.fixture(scope="module")
def scene():
    """Raw pods (for JAX's row layout), their words (for the ranks), the
    cameras and the multi-model transforms, as `tests/test_parallel.py`."""
    raw = {"pod": _raw_pod(768, 0), "pod_a": _raw_pod(640, 0), "pod_b": _raw_pod(512, 5)}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    models = np.stack([EYE, EYE.copy()])
    models[1, 2, 3] = 0.4
    s = {k: flat_pod_to_words(v, COMP) for k, v in raw.items()}
    s.update(view=cam.view(), proj=cam.projection(64 / 64), proj48=cam.projection(64 / 48),
             models=models, ranks=[1, 0])
    return raw, s


@pytest.fixture(scope="module")
def ranks(scene, tmp_path_factory):
    """world -> every rank's results, one spawn per world, on first use."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"ranks{world}")
            cache[world] = spawn_ranks(world, scene[1], str(out))
        return cache[world]

    return get


def _single(words, cfg, view, proj):
    pod = pod_to_tensors(words, "cpu")
    return over_background(render_frame(pod, COMP, cfg, view, proj, EYE, sh_degree=3),
                           np.zeros(3)).numpy()


def _single_merged(s):
    """The port's single-device merged frame: both models' entries with
    their ranks in one buffer, one sort, one composite."""
    cfg_m = dataclasses.replace(CFG, model_bits=1)
    parts = []
    for name, model, rank in zip(("pod_a", "pod_b"), s["models"], s["ranks"]):
        pre = preprocess(pod_to_tensors(s[name], "cpu"), COMP, s["view"], s["proj"], model,
                         CFG.width, CFG.height, sh_degree=3)
        parts.append(enumerate_entries_from_pre(pre, cfg_m, model_rank=rank))
    se = sort_entries(torch.cat(parts), cfg_m)
    return over_background(composite_tiles_v2(se, cfg_m), np.zeros(3)).numpy()


def _jax_pod(raw, mesh):
    rows = jcomp.pod_rows(raw, jcomp.Compressions())
    return jpar.shard_pod({k: jnp.asarray(v) for k, v in rows.items()}, mesh)


def _jax_frame(raw, n_dev, cfg, view, proj):
    mesh = jpar.make_mesh(jax.devices()[:n_dev])
    jcfg = JTileConfig(cfg.width, cfg.height, tile=cfg.tile, max_dup=cfg.max_dup)
    return np.asarray(jpar.render_sharded(_jax_pod(raw, mesh), mesh, jcomp.Compressions(), jcfg,
                                          view, proj, sh_degree=3, use_pallas=False,
                                          ragged=False))


def _all_ranks_equal(results, key):
    for r in results[1:]:
        np.testing.assert_array_equal(r[key], results[0][key])
    return results[0][key]


def _close(img, ref, tol):
    assert img.shape == ref.shape
    err = float(np.abs(img - ref).max())
    assert err <= tol, f"max abs {err:.3e} > {tol:.3e}"


def _jax_close(img, ref):
    assert img.shape == ref.shape
    assert np.abs(img - ref).mean() < 1e-3
    assert np.abs(img - ref).max() < 0.05


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_matches_single_device(scene, ranks, world):
    """Every rank returns the same frame: the single-device `render_frame`
    bit for bit at 1 rank, within EXIT_TOL at 2 and 4; a mesh made from an
    `init_device_mesh` mesh renders the same frame as one from the group."""
    s = scene[1]
    res = ranks(world)
    img = _all_ranks_equal(res, "frame")
    np.testing.assert_array_equal(_all_ranks_equal(res, "frame_device_mesh"), img)
    ref = _single(s["pod"], CFG, s["view"], s["proj"])
    if world == 1:
        np.testing.assert_array_equal(img, ref)
    else:
        _close(img, ref, EXIT_TOL)
    assert [int(r["shard"][0]) for r in res] == [shard_bounds(768, world, i)[1]
                                                 - shard_bounds(768, world, i)[0]
                                                 for i in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_matches_jax(scene, ranks, world):
    raw, s = scene
    img = _all_ranks_equal(ranks(world), "frame")
    _jax_close(img, _jax_frame(raw["pod"], world, CFG, s["view"], s["proj"]))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_nondivisible_height(scene, ranks, world):
    """64x48: 3 tile rows, so at 4 ranks one slab lies past the screen and
    at 2 the second slab's last row does."""
    raw, s = scene
    img = _all_ranks_equal(ranks(world), "nondiv")
    assert slab_config(CFG48, world)[2] >= 48
    _close(img, _single(s["pod"], CFG48, s["view"], s["proj48"]), EXIT_TOL)
    if world == 4:
        _jax_close(img, _jax_frame(raw["pod"], 4, CFG48, s["view"], s["proj48"]))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_multi_model(scene, ranks, world):
    """Two models, ranks [1, 0] (model 1 nearer): the merged sharded frame
    against the port's single-device merged entries (bit for bit at 1 rank)
    and, at 4, against JAX's `render_frame_sharded_multi`."""
    raw, s = scene
    res = ranks(world)
    img = _all_ranks_equal(res, "multi")
    assert all(int(r["multi_overflow"]) == 0 for r in res)
    ref = _single_merged(s)
    if world == 1:
        np.testing.assert_array_equal(img, ref)
    else:
        _close(img, ref, EXIT_TOL)
    if world == 4:
        mesh = jpar.make_mesh(jax.devices()[:4])
        jimg, overflow = jpar.render_frame_sharded_multi(
            (_jax_pod(raw["pod_a"], mesh), _jax_pod(raw["pod_b"], mesh)), mesh, "splats",
            jcomp.Compressions(), JTileConfig(64, 64, tile=16, max_dup=8), jnp.asarray(s["view"]),
            jnp.asarray(s["proj"]), jnp.asarray(s["models"]), jnp.asarray(s["ranks"], jnp.uint32),
            jnp.zeros(3, jnp.float32), sh_degree=3, use_pallas=False, ragged=False)
        assert int(np.asarray(overflow).max()) == 0
        _jax_close(img, np.asarray(jimg)[:64])


def _clamped_count(mat):
    """Entries the routing drops: owner j takes the runs in source order
    into its capacity; a run that does not fit is cut, later ones dropped."""
    s, cap = mat[:, :-1], mat[:, -1]
    dropped = 0
    for j in range(s.shape[1]):
        room = int(cap[j])
        for i in range(s.shape[0]):
            take = min(int(s[i, j]), room)
            dropped += int(s[i, j]) - take
            room -= take
    return dropped


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_overflow_small_capacity(ranks, world):
    """capacity_factor 0.05: entries are dropped, the overflow (the same on
    every rank) is the count of the clamp over the gathered send matrix,
    and the image is still finite and whole."""
    res = ranks(world)
    mat = _all_ranks_equal(res, "send_matrix")
    overflow = int(_all_ranks_equal(res, "small_cap_overflow"))
    assert overflow > 0
    assert overflow == _clamped_count(mat)
    img = _all_ranks_equal(res, "small_cap")
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_overflow_zero_at_default_capacity(ranks, world):
    """The default capacity drops nothing; `last_stats()` and the app
    server's `/state` section report it with the rank count."""
    for r in ranks(world):
        assert int(r["frame_overflow"]) == 0 and int(r["default_overflow"]) == 0
        assert r["last_stats"].tolist() == [0, world]
        assert r["server_stats"].tolist() == [0, world]


def test_clamp_plan_matches_loop():
    """The vectorised clamp against the loop above on random matrices."""
    rng = np.random.default_rng(0)
    for world in (1, 2, 3, 4, 8):
        for _ in range(20):
            mat = rng.integers(0, 50, (world, world + 1))
            sizes, overflow = _clamp_plan(mat)
            assert overflow == _clamped_count(mat)
            assert (sizes.sum(axis=0) <= mat[:, -1]).all() and (sizes >= 0).all()


@pytest.mark.parametrize("n,world", [(768, 4), (10, 3), (2, 4), (0, 2)])
def test_shard_pod_contiguous_runs(scene, n, world):
    """The shards are contiguous runs in splat order that tile the pod."""
    words = {k: v[..., :n] for k, v in scene[1]["pod"].items()}
    parts = [shard_pod(words, Mesh(group=None, rank=r, world=world, device=torch.device("cpu")))
             for r in range(world)]
    whole = pod_to_tensors(words, "cpu")
    for k in whole:
        torch.testing.assert_close(torch.cat([p[k] for p in parts], dim=-1), whole[k],
                                   rtol=0, atol=0)
    sizes = [p["color0"].shape[-1] for p in parts]
    assert sum(sizes) == n and max(sizes) - min(sizes) <= 1


def test_make_mesh_needs_a_group():
    """make_mesh never initialises a backend itself."""
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh()
