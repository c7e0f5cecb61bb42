"""The row-major mode of the port's v2 compositor (the plain version of
kernel K3, which serves every `transposed` and `mxu`) against the JAX Pallas
kernel `_composite_kernel_v2` in interpret mode
(`composite_tiles_pallas_v2(transposed=False)`), with the Horner and the
quadratic-basis (`mxu=True`) exponent, in splat and flat mode; and that a
CPU call reaches the plain version whichever flags it passes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops.composite import composite_tiles_pallas_v2
from wgpu_3dgs_viewer_app_tpu_torch.convert import sorted_entries_to_jax
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.data import (
    Compressions, flat_pod_to_words, make_random_scene, pack_gaussians, pod_to_tensors)
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    TileConfig, build_sorted_entries_fused, composite_tiles_plain_v2, composite_tiles_v2, kernels)

# The reference's own compositor tolerance. The quadratic-basis form
# cancels terms of ~1e4, so it holds only because the plain version rounds
# each step as the reference's CPU build does (fused multiply-adds where it
# contracts); measured 1.2e-7 to 1.8e-7 on these scenes, and the same form
# without them 2.0e-5 to 2.7e-5 away.
ATOL = 1e-5


def _sorted(n, w, h, mode, seed):
    comp = Compressions()
    g = make_random_scene(n, seed=seed, extent=1.2, scale_range=(0.01, 0.06))
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), "cpu")
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.2, 0.3, -3.5))
    cfg = TileConfig(w, h, tile=16, max_dup=8)
    se = build_sorted_entries_fused(pod, comp, cfg, cam.view(), cam.projection(w / h),
                                    np.eye(4, dtype=np.float32), display_mode=mode)
    jse = jbin.SortedEntries(*map(jnp.asarray, sorted_entries_to_jax(se)))
    return se, cfg, jse, jbin.TileConfig(w, h, tile=16, max_dup=8)


@pytest.mark.parametrize("mode,mxu,shape", [
    (0, True, (500, 64, 64)), (0, True, (400, 100, 76)), (0, False, (500, 64, 64)),
    (2, False, (500, 64, 64)), (1, True, (400, 100, 76))],
    ids=["splat-mxu", "splat-mxu-100x76", "splat-horner", "point", "ellipse-mxu"])
def test_rows_plain_matches_jax_kernel(mode, mxu, shape):
    """Same sorted entries through the port's plain v2 compositor and the
    JAX row-major kernel (interpret mode) with the same `mxu`: flat mode
    falls back to the Horner form in both."""
    n, w, h = shape
    se, cfg, jse, jcfg = _sorted(n, w, h, mode, seed=w)
    flat = mode != 0
    ref = np.asarray(composite_tiles_pallas_v2(jse, jcfg, flat_mode=flat, interpret=True,
                                               transposed=False, mxu=mxu))
    got = composite_tiles_v2(se, cfg, flat_mode=flat, transposed=False, mxu=mxu).numpy()
    assert got.shape == ref.shape == (h, w, 4)
    assert got[..., 3].mean() > 0.1
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_quadratic_basis_differs_from_horner_only_by_rounding():
    """The two exponent forms give the same image to within the quadratic
    form's cancellation (measured 2.2e-5 to 3.6e-5 on these scenes), and
    flat mode ignores `mxu`."""
    se, cfg, _, _ = _sorted(500, 64, 64, 0, seed=1)
    horner = composite_tiles_plain_v2(se, cfg)
    quad = composite_tiles_plain_v2(se, cfg, mxu=True)
    assert 0 < float((quad - horner).abs().max()) < 1e-4
    flat, _, _, _ = _sorted(500, 64, 64, 2, seed=1)
    assert torch.equal(composite_tiles_plain_v2(flat, cfg, flat_mode=True, mxu=True),
                       composite_tiles_plain_v2(flat, cfg, flat_mode=True))


@pytest.mark.parametrize("kw", [{"transposed": False}, {"mxu": True}, {}],
                         ids=["rows", "mxu", "default"])
def test_cpu_call_reaches_plain_version(kw):
    """On CPU entries every kernel choice runs the plain version and
    launches nothing."""
    se, cfg, _, _ = _sorted(300, 48, 48, 0, seed=2)
    before = dict(kernels.LAUNCHES)
    got = composite_tiles_v2(se, cfg, **kw)
    assert kernels.LAUNCHES == before
    assert torch.equal(got, composite_tiles_plain_v2(se, cfg, mxu=kw.get("mxu", False)))
