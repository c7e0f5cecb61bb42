"""Port core math against the JAX package: the integer f16 codec (bit
exact), covariance/EWA, SH (rtol 1e-5), cameras and transforms (exact)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.core import camera as jcam
from wgpu_3dgs_viewer_app_tpu.core import covariance as jcov
from wgpu_3dgs_viewer_app_tpu.core import f16 as jf16
from wgpu_3dgs_viewer_app_tpu.core import sh as jsh
from wgpu_3dgs_viewer_app_tpu.core import transform as jtr
from wgpu_3dgs_viewer_app_tpu_torch.core import camera as tcam
from wgpu_3dgs_viewer_app_tpu_torch.core import covariance as tcov
from wgpu_3dgs_viewer_app_tpu_torch.core import f16 as tf16
from wgpu_3dgs_viewer_app_tpu_torch.core import sh as tsh
from wgpu_3dgs_viewer_app_tpu_torch.core import transform as ttr

RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def test_f16_decode_all_patterns():
    h = np.arange(65536, dtype=np.uint32)
    ref = np.asarray(jf16.f16_bits_to_f32(jnp.asarray(h))).view(np.uint32)
    got = tf16.f16_bits_to_f32(_t(h.astype(np.int64))).numpy().view(np.uint32)
    assert np.array_equal(ref, got)


def test_f16_encode_bit_exact():
    """Random f32 plus +-0, subnormals, f16-subnormal range, overflow,
    infinities, NaN, exact f16 values and halfway cases."""
    rng = np.random.default_rng(0)
    halves = np.arange(0, 0x7C00, dtype=np.uint32)
    exact = np.asarray(jf16.f16_bits_to_f32(jnp.asarray(halves)))
    f32bits = exact.view(np.uint32)
    halfway = (f32bits + np.uint32(0x1000)).view(np.float32)  # ties round up
    special = np.array([0.0, -0.0, 1e-45, -1e-45, 1e-40, 5.9e-8, 6.1e-5, -6.1e-5, 65504.0,
                        65519.0, 65520.0, 1e6, -1e6, np.inf, -np.inf, np.nan, 3.4e38],
                       np.float32)
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * np.float32(100.0),
        (rng.random(20000).astype(np.float32) - 0.5) * np.float32(1e-4),
        exact, -exact, halfway, -halfway, special,
        rng.integers(0, 2**32, 20000, dtype=np.uint64).astype(np.uint32).view(np.float32),
    ])
    ref = np.asarray(jf16.f32_to_f16_bits(jnp.asarray(x)))
    got = tf16.f32_to_f16_bits(_t(x)).numpy()
    assert np.array_equal(ref.astype(np.int64), got)
    # pack/unpack pairs agree too
    w = tf16.pack2xf16(_t(x[:1000]), _t(x[1000:2000]))
    assert np.array_equal(np.asarray(jf16.pack2xf16(jnp.asarray(x[:1000]),
                                                    jnp.asarray(x[1000:2000]))), w.numpy())


def _rand_cov_inputs(n, seed):
    rng = np.random.default_rng(seed)
    scale = np.exp(rng.uniform(-4, -1, (n, 3))).astype(np.float32)
    quat = rng.standard_normal((n, 4)).astype(np.float32)
    return scale, quat


def test_cov3d_from_scale_rot_matches():
    scale, quat = _rand_cov_inputs(2000, 1)
    ref = np.asarray(jcov.cov3d_from_scale_rot(jnp.asarray(scale), jnp.asarray(quat)))
    got = tcov.cov3d_from_scale_rot(_t(scale), _t(quat)).numpy()
    # Eager JAX rounds exactly like the port (the packed pods depend on it).
    assert np.array_equal(ref, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_ewa_projection_matches(seed):
    rng = np.random.default_rng(seed)
    n = 3000
    scale, quat = _rand_cov_inputs(n, seed + 10)
    cov6 = np.asarray(jcov.cov3d_from_scale_rot(jnp.asarray(scale), jnp.asarray(quat)))
    m = jtr.quat_to_mat3(jtr.quat_from_euler_zyx_deg(rng.uniform(-90, 90, 3))) * np.float32(1.3)
    cam = jcam.CameraOrbitControl(target=(0, 0, 0), pos=(0.5, 0.4, -3.0))
    view = cam.view()
    proj = cam.projection(1.5)
    pts = rng.uniform(-1, 1, (3, n)).astype(np.float32)
    tv = [view[i, 0] * pts[0] + view[i, 1] * pts[1] + view[i, 2] * pts[2] + view[i, 3]
          for i in range(3)]
    fx, fy = np.float32(0.5 * 300) * proj[0, 0], np.float32(0.5 * 200) * proj[1, 1]
    tan = (np.float32(1.0) / proj[0, 0], np.float32(1.0) / proj[1, 1])

    jc6 = jcov.transform_cov6_t(tuple(jnp.asarray(cov6[:, i]) for i in range(6)), jnp.asarray(m))
    tc6 = tcov.transform_cov6_t(tuple(_t(cov6[:, i]) for i in range(6)), m.tolist())
    for a, b in zip(jc6, tc6):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-9)

    j2d = jcov.project_cov3d_to_cov2d(jc6, tuple(jnp.asarray(v) for v in tv),
                                      jnp.asarray(view[:3, :3]), (fx, fy), tan)
    t2d = tcov.project_cov3d_to_cov2d(tc6, tuple(_t(v) for v in tv), view[:3, :3].tolist(),
                                      (float(fx), float(fy)), tuple(float(v) for v in tan))
    for a, b in zip(j2d, t2d):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-6)

    (ja, jb, jcc), jr, jv = jcov.cov2d_to_conic_radius(j2d)
    (ta, tb, tcc), tr, tv_ = tcov.cov2d_to_conic_radius(t2d)
    for a, b in ((ja, ta), (jb, tb), (jcc, tcc)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-6)
    assert np.array_equal(np.asarray(jv), tv_.numpy())
    # radius is a ceil: allow one step where the argument lands an ulp apart
    assert np.abs(np.asarray(jr) - tr.numpy()).max() <= 1.0
    assert (np.asarray(jr) == tr.numpy()).mean() > 0.999


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_rest_channels_match(degree):
    rng = np.random.default_rng(degree)
    n = 2000
    d = rng.standard_normal((3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    coeffs = rng.standard_normal((15, 3, n)).astype(np.float32) * np.float32(0.3)
    ref = jsh.eval_sh_rest_channels(lambda k, c: jnp.asarray(coeffs[k, c]),
                                    *(jnp.asarray(v) for v in d), degree)
    got = tsh.eval_sh_rest_channels(lambda k, c: _t(coeffs[k, c]), *(_t(v) for v in d), degree)
    for a, b in zip(ref, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=1e-6)
    assert tsh.SH_C0 == jsh.SH_C0 and tsh.SH_C3 == jsh.SH_C3


def test_camera_and_transforms_match():
    for pos, target, aspect in (((0, 0, -6), (0, 0, 0), 16 / 9),
                                ((1.5, 0.9, 2.0), (0.2, -0.1, 0.3), 1.0)):
        a = jcam.CameraOrbitControl(target=target, pos=pos)
        b = tcam.CameraOrbitControl(target=target, pos=pos)
        assert np.array_equal(a.view(), b.view())
        assert np.array_equal(a.projection(aspect), b.projection(aspect))
        a.orbit_by(0.3, -0.2)
        b.orbit_by(0.3, -0.2)
        a.zoom_by(1.3)
        b.zoom_by(1.3)
        a.pan_by((0.1, 0.2, 0.0))
        b.pan_by((0.1, 0.2, 0.0))
        assert np.array_equal(a.view(), b.view())
    for rot in ((0, 0, 0), (30, -45, 60), (90, 10, -170)):
        ja = jtr.ModelTransform(pos=np.array([1, 2, 3], np.float32), rot=np.array(rot, np.float32),
                                scale=np.array([1, 2, 0.5], np.float32))
        tb = ttr.ModelTransform(pos=np.array([1, 2, 3], np.float32), rot=np.array(rot, np.float32),
                                scale=np.array([1, 2, 0.5], np.float32))
        assert np.array_equal(ja.matrix(), tb.matrix())
    gt = ttr.GaussianTransform()
    assert gt.sh_deg.degree == 3 and gt.display_mode == ttr.GaussianDisplayMode.SPLAT
    with pytest.raises(ValueError):
        ttr.GaussianShDegree(4)
    assert math.isclose(tcam.perspective_rh(1.0, 2.0, 0.1, 10.0)[3, 2], -1.0)
