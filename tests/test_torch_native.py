"""The port's native codec (`native/gsnative.cpp`, `native/build.py`,
`data/native.py`), its last scene makers and its small host helpers on the
CPU, against the JAX package.

The JAX codec is built here from its own source with its own flags into a
temporary directory and loaded by its own bridge, so the two compiled
codecs are held bit for bit (`np.array_equal`) on one machine; the port's
codec is also held against the port's numpy pack within
`tests/test_native.py`'s tolerances. Tests of a codec skip where the
machine has no C++ compiler. Scene makers: byte-equal. Helpers: the same
f32 operations, held within 1e-6 where a sum's order may differ.
"""

import shutil
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.core import camera as jcamera
from wgpu_3dgs_viewer_app_tpu.core import covariance as jcov
from wgpu_3dgs_viewer_app_tpu.core import sh as jsh
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.data import native as jnative
from wgpu_3dgs_viewer_app_tpu.data import synthetic as jsyn
from wgpu_3dgs_viewer_app_tpu.ops.preprocess import camera_position_from_view as j_cam_pos
from wgpu_3dgs_viewer_app_tpu_torch.convert import pod_from_jax
from wgpu_3dgs_viewer_app_tpu_torch.core import camera as tcamera
from wgpu_3dgs_viewer_app_tpu_torch.core import covariance as tcov
from wgpu_3dgs_viewer_app_tpu_torch.core import sh as tsh
from wgpu_3dgs_viewer_app_tpu_torch.data import compression as tcomp
from wgpu_3dgs_viewer_app_tpu_torch.data import native as tnative
from wgpu_3dgs_viewer_app_tpu_torch.data import synthetic as tsyn
from wgpu_3dgs_viewer_app_tpu_torch.native import build as tbuild
from wgpu_3dgs_viewer_app_tpu_torch.ops.preprocess import camera_position_from_view

COMP_IDS = [f"{c.sh.value}-{c.cov3d.value}" for c in tcomp.ALL_COMPRESSIONS]


def _comp_pair(i):
    return jcomp.ALL_COMPRESSIONS[i], tcomp.ALL_COMPRESSIONS[i]


@pytest.fixture(scope="module")
def jax_codec(tmp_path_factory):
    """The JAX bridge over a private build of the JAX codec (its source,
    its flags), put back as it was afterwards."""
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler: the native codecs cannot be built")
    from wgpu_3dgs_viewer_app_tpu.native import build as jbuild

    out = tmp_path_factory.mktemp("jax_codec") / "libgsnative.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbuild, "OUT", out)
        jbuild.build(verbose=False)
        mp.setattr(jnative, "_LIB_PATH", out)
        mp.setattr(jnative, "_lib", None)
        assert jnative.available()
        yield jnative


@pytest.fixture
def codec():
    """The port's bridge, its library built at first use."""
    if tbuild.compiler() is None:
        pytest.skip("no C++ compiler: the native codec cannot be built")
    assert tnative.available()
    return tnative


def _assert_same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), f"{k}: {int((a[k] != b[k]).sum())} differ"


@pytest.mark.parametrize("i", range(8), ids=COMP_IDS)
def test_native_pack_equals_jax_native(jax_codec, codec, i):
    """The two codecs, array for array, on the JAX codec test's scene."""
    jc, tc = _comp_pair(i)
    ref = jax_codec.pack_gaussians_native(jsyn.make_random_scene(5000, seed=11), jc)
    got = codec.pack_gaussians_native(tsyn.make_random_scene(5000, seed=11), tc)
    _assert_same_arrays(got, ref)


@pytest.mark.parametrize("i", range(8), ids=COMP_IDS)
def test_native_pack_near_numpy(codec, i):
    """The port's codec against the port's numpy pack, within the JAX
    codec test's tolerances: pos equal, u8 fields +-1, cov3d rtol 1e-3."""
    tc = tcomp.ALL_COMPRESSIONS[i]
    g = tsyn.make_random_scene(5000, seed=11)
    ref = tcomp.pack_gaussians(g, tc, use_native=False)
    out = codec.pack_gaussians_native(g, tc)
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["pos"], ref["pos"])
    for shift in (0, 8, 16, 24):
        a = (out["color0"] >> shift) & 0xFF
        b = (ref["color0"] >> shift) & 0xFF
        assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    if "sh" in ref:
        if ref["sh"].dtype == np.uint8:
            assert np.abs(out["sh"].astype(int) - ref["sh"].astype(int)).max() <= 1
            np.testing.assert_allclose(out["sh_mn"], ref["sh_mn"], rtol=1e-6)
            np.testing.assert_allclose(out["sh_span"], ref["sh_span"], rtol=1e-6)
        else:
            np.testing.assert_allclose(out["sh"].astype(np.float32),
                                       ref["sh"].astype(np.float32), atol=1e-6)
    np.testing.assert_allclose(out["cov3d"].astype(np.float32), ref["cov3d"].astype(np.float32),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("i", [0, 5], ids=[COMP_IDS[0], COMP_IDS[5]])
def test_native_pack_one_thread_equals_default(codec, i):
    g = tsyn.make_random_scene(20000, seed=12)
    tc = tcomp.ALL_COMPRESSIONS[i]
    _assert_same_arrays(codec.pack_gaussians_native(g, tc, n_threads=1),
                        codec.pack_gaussians_native(g, tc))


@pytest.mark.parametrize("i", range(8), ids=COMP_IDS)
def test_default_pack_words_equal_jax_default(jax_codec, codec, i):
    """`pack_gaussians` defaults to the codec in both packages: the port's
    word pod equals JAX's default flat pack word for word, and is the
    codec's own output."""
    jc, tc = _comp_pair(i)
    g = tsyn.make_random_scene(5000, seed=11)
    got = tcomp.flat_pod_to_words(tcomp.pack_gaussians(g, tc), tc)
    ref = jcomp.flat_pod_to_words(jcomp.pack_gaussians(jsyn.make_random_scene(5000, seed=11),
                                                       jc, layout="flat"), jc)
    _assert_same_arrays(got, ref)
    _assert_same_arrays(got, tcomp.flat_pod_to_words(codec.pack_gaussians_native(g, tc), tc))


def test_failed_build_raises(codec, tmp_path, monkeypatch):
    """Where the compiler is there and the build fails, packing raises; it
    does not fall back to numpy."""
    bad = tmp_path / "gsnative.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SRC", bad)
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tcomp.pack_gaussians(tsyn.make_random_scene(100, seed=1), tcomp.Compressions())
    assert not list((tmp_path / "build").glob("*.so"))


def test_no_compiler_packs_with_numpy(monkeypatch):
    """Without a C++ compiler the codec is unavailable and the default pack
    is numpy's."""
    monkeypatch.setattr(tbuild, "compiler", lambda: None)
    monkeypatch.setattr(tnative, "_lib", None)
    assert not tnative.available()
    assert tnative.pack_gaussians_native(tsyn.make_random_scene(10, seed=1),
                                         tcomp.Compressions()) is None
    g = tsyn.make_random_scene(3000, seed=4)
    tc = tcomp.Compressions()
    _assert_same_arrays(tcomp.pack_gaussians(g, tc), tcomp.pack_gaussians(g, tc, use_native=False))


def test_concurrent_builds_agree(codec, tmp_path, monkeypatch):
    """Threads that build at once into an empty directory all get the one
    library, named by the digest and renamed into place whole."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def run():
        try:
            paths.append(tbuild.build())
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    threads = [threading.Thread(target=run) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and len(paths) == 4 and len(set(paths)) == 1
    assert [p.name for p in tmp_path.iterdir()] == [paths[0].name]
    assert paths[0].name.startswith("libgsnative_") and tbuild.build() == paths[0]


# --- scene makers -------------------------------------------------------------


def _assert_same_scene(a, b):
    for f in ("pos", "normal", "sh0", "sh_rest", "opacity", "scale", "rot"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("n,seed,scale", [(20000, 0, 4.0), (5000, 3, 4.0), (777, 11, 1.5)])
def test_make_inria_like_scene_byte_equal(n, seed, scale):
    _assert_same_scene(tsyn.make_inria_like_scene(n, seed=seed, scene_scale=scale),
                       jsyn.make_inria_like_scene(n, seed=seed, scene_scale=scale))


@pytest.mark.parametrize("side,spacing,scale", [(8, 0.5, 0.08), (3, 1.0, 0.2), (5, 0.25, 0.05)])
def test_make_grid_scene_byte_equal(side, spacing, scale):
    _assert_same_scene(tsyn.make_grid_scene(side, spacing, scale),
                       jsyn.make_grid_scene(side, spacing, scale))


# --- small helpers ----------------------------------------------------------


@pytest.mark.parametrize("degree", range(4))
def test_sh_basis_and_eval_sh_match_jax(degree):
    rng = np.random.default_rng(degree)
    dirs = rng.standard_normal((257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    sh0 = rng.standard_normal((257, 3)).astype(np.float32)
    rest = (rng.standard_normal((257, 15, 3)) * 0.1).astype(np.float32)
    assert tsh.N_COEFFS_FOR_DEGREE == jsh.N_COEFFS_FOR_DEGREE
    np.testing.assert_allclose(tsh.sh_basis(torch.from_numpy(dirs), degree).numpy(),
                               np.asarray(jsh.sh_basis(jnp.asarray(dirs), degree)),
                               rtol=1e-6, atol=1e-7)
    for no_sh0 in (False, True):
        got = tsh.eval_sh(torch.from_numpy(sh0), torch.from_numpy(rest), torch.from_numpy(dirs),
                          degree, no_sh0=no_sh0).numpy()
        ref = np.asarray(jsh.eval_sh(jnp.asarray(sh0), jnp.asarray(rest), jnp.asarray(dirs),
                                     degree, no_sh0=no_sh0))
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_covariance_helpers_match_jax():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((300, 4)).astype(np.float32)
    np.testing.assert_allclose(tcov.quat_to_mat3(torch.from_numpy(q)).numpy(),
                               np.asarray(jcov.quat_to_mat3_jnp(jnp.asarray(q))),
                               rtol=1e-6, atol=1e-7)
    cov6 = rng.standard_normal((300, 6)).astype(np.float32)
    m = rng.standard_normal((3, 3)).astype(np.float32)
    np.testing.assert_allclose(tcov.transform_cov6(torch.from_numpy(cov6), m.tolist()).numpy(),
                               np.asarray(jcov.transform_cov6(jnp.asarray(cov6), jnp.asarray(m))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tcov.unpack_cov3d(torch.from_numpy(cov6)).numpy(),
                                  np.asarray(jcov.unpack_cov3d(jnp.asarray(cov6))))


@pytest.mark.parametrize("pos", [(0.0, 0.0, -4.0), (0.3, 0.2, -4.0), (5.0, -2.0, 7.5)])
def test_camera_position_from_view_matches_jax(pos):
    assert tcamera.Vec3 is jcamera.Vec3 is np.ndarray
    view = tcamera.CameraOrbitControl(target=(0.1, 0, 0), pos=pos).view()
    got = camera_position_from_view(view)
    ref = np.asarray(j_cam_pos(jnp.asarray(view)))
    assert got.dtype == np.float32 and got.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(pos, np.float32), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("i", range(8), ids=COMP_IDS)
def test_unpack_sh_and_cov3d_match_jax(i):
    """The word-pod decoders against JAX's over its row pod (the first N
    of its padded rows)."""
    jc, tc = _comp_pair(i)
    g = jsyn.make_random_scene(300, seed=2)
    rows = jcomp.pack_gaussians(g, jc, use_native=False)
    pod = pod_from_jax(rows, tc, "cpu", n=g.count)
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    np.testing.assert_array_equal(tcomp.unpack_sh(pod, tc).numpy(),
                                  np.asarray(jcomp.unpack_sh(jrows, jc))[:g.count])
    np.testing.assert_array_equal(tcomp.unpack_cov3d(pod).numpy(),
                                  np.asarray(jcomp.unpack_cov3d(jrows))[:g.count])
