"""Port edit math (`core/edit.py`) against the JAX package on the same
inputs, made from numpy seeds.

Tolerance: `apply_edit` and `apply_edit_components` within 1e-6 absolute
of their JAX counterparts (torch's and XLA's exp2/log2/pow on the CPU
round an ulp apart; every value lies in [0, 1] after the edit, where an
ulp is below 6e-8); `apply_edit_np` and the identity SoA byte-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.core import edit as jedit
from wgpu_3dgs_viewer_app_tpu_torch.core import edit as tedit

N = 2048
ENABLED, HIDDEN, OVERRIDE = (tedit.EDIT_FLAG_ENABLED, tedit.EDIT_FLAG_HIDDEN,
                             tedit.EDIT_FLAG_OVERRIDE_COLOR)


def _inputs(case, seed=0):
    """rgb (a little outside [0, 1] too), opacity, u32 flags, edit rgb and
    params for one named case."""
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(-0.1, 1.1, (N, 3)).astype(np.float32)
    rgb[:64] = rgb[:64, :1]  # grey: delta = 0, hue 0
    opacity = rng.uniform(0.0, 1.0, N).astype(np.float32)
    flags = rng.integers(0, 8, N).astype(np.uint32)
    ergb = rng.uniform([-1.5, 0.0, 0.0], [1.5, 2.0, 2.0], (N, 3)).astype(np.float32)
    params = rng.uniform([-0.5, -1.0, 0.3, 0.0], [0.5, 1.0, 3.0, 1.0], (N, 4)).astype(np.float32)
    if case == "hidden":
        flags[:] = ENABLED | HIDDEN
    elif case == "override":
        flags[:] = ENABLED | OVERRIDE
        ergb = rng.uniform(0.0, 1.0, (N, 3)).astype(np.float32)
    elif case == "hue_wrap":
        flags[:] = ENABLED
        ergb[:, 0] = rng.choice(np.float32([0.9, -0.9, 1.0, 2.5]), N)
    elif case == "gamma":
        flags[:] = ENABLED
        params[:, 2] = rng.choice(np.float32([0.0, 1e-7, 0.25, 1.0, 4.0]), N)
    elif case == "disabled":
        flags[:] = rng.choice(np.uint32([0, HIDDEN, OVERRIDE, HIDDEN | OVERRIDE]), N)
    return rgb, opacity, flags, ergb, params


CASES = ["mixed", "hidden", "override", "hue_wrap", "gamma", "disabled"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("case", CASES)
def test_apply_edit_matches_jax(case):
    """Stacked form against JAX `apply_edit`: abs 1e-6."""
    rgb, op, flags, ergb, params = _inputs(case)
    ref = jedit.apply_edit(*(jnp.asarray(a) for a in (rgb, op, flags, ergb, params)))
    got = tedit.apply_edit(*(_t(a) for a in (rgb, op, flags, ergb, params)))
    for r, g, name in zip(ref, got, ("rgb", "opacity", "hidden")):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6, err_msg=name)
    if case == "disabled":
        assert np.array_equal(got[0].numpy(), rgb) and not got[2].any()


@pytest.mark.parametrize("case", CASES)
def test_apply_edit_components_matches_jax(case):
    """Component form (the kernels' plain version) against JAX
    `apply_edit_components`: abs 1e-6."""
    rgb, op, flags, ergb, params = _inputs(case, seed=1)
    cols = lambda x: [x[:, k] for k in range(x.shape[1])]  # noqa: E731
    ref = jedit.apply_edit_components(
        *(jnp.asarray(c) for c in cols(rgb) + [op, flags] + cols(ergb) + cols(params)))
    args = cols(rgb) + [op, flags.astype(np.int64)] + cols(ergb) + cols(params)
    got = tedit.apply_edit_components(*(torch.from_numpy(np.ascontiguousarray(c)) for c in args))
    for k, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6, err_msg=f"out {k}")


@pytest.mark.parametrize("case", ["mixed", "hue_wrap", "gamma"])
def test_apply_edit_np_byte_equal(case):
    args = _inputs(case, seed=2)
    for r, g in zip(jedit.apply_edit_np(*args), tedit.apply_edit_np(*args)):
        assert r.dtype == g.dtype and r.tobytes() == g.tobytes()


def test_pods_and_identity_soa_equal():
    for r, g in zip(jedit.make_edit_soa(300), tedit.make_edit_soa(300)):
        assert r.dtype == g.dtype and r.tobytes() == g.tobytes()
    kw = dict(flags=ENABLED | OVERRIDE, rgb_or_hsv=(0.1, 0.2, 0.3), contrast=0.4, exposure=-0.5,
              gamma=2.0, alpha=0.6)
    pods = jedit.GaussianEditPod(**kw), tedit.GaussianEditPod(**kw)
    for r, g in zip(*(p.as_arrays() for p in pods)):
        assert np.asarray(r).tobytes() == np.asarray(g).tobytes()
    assert jedit.SelectionHighlightPod().rgba == tedit.SelectionHighlightPod().rgba
