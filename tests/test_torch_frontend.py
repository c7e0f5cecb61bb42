"""Port front-end (plain version of kernel K1: preprocess + enumerate/pack)
against the JAX package: the Pallas front-end kernel in interpret mode, the
JAX preprocess, and the JAX enumeration on the same PreprocessOut.

Entry tolerance (stated in `wgpu_3dgs_viewer_app_tpu_torch/testing.py`): the
two sides are compared slot for slot (which implies their sorted live-entry
multisets agree within the same bound). At least 99.9% of the slots live in
either side are bit-identical; every other one is live in both, in the same
tile, and each quantised field (log-depth, alpha byte, u12 means, colour
bytes, f16 conic bits) is within one step. XLA:CPU and torch round their
transcendentals an ulp apart, which is all this allows for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene as j_make_random_scene
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops.fused import enumerate_entries_fused as j_enumerate_fused
from wgpu_3dgs_viewer_app_tpu.ops.preprocess import preprocess as j_preprocess
from wgpu_3dgs_viewer_app_tpu_torch.convert import pod_from_jax
from wgpu_3dgs_viewer_app_tpu_torch.data import compression as tcomp
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    PreprocessOut, TileConfig, enumerate_entries_from_pre, enumerate_entries_fused, preprocess)
from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries

W = H = 128


def _scene(comp_index, n=2048, seed=5):
    """JAX rows pod + the same pod in the port's words, and the camera."""
    jc, tc = jcomp.ALL_COMPRESSIONS[comp_index], tcomp.ALL_COMPRESSIONS[comp_index]
    g = j_make_random_scene(n, seed=seed, extent=1.2, scale_range=(0.01, 0.05))
    rows = jcomp.pack_gaussians(g, jc, use_native=False)
    cam = JCamera(target=(0, 0, 0), pos=(0.3, 0.2, -4))
    return jc, tc, rows, pod_from_jax(rows, tc, "cpu", n=n), cam.view(), cam.projection(W / H)


def _jax_fused_to_slots(planes, n, d):
    """JAX fused output (4 flat planes, entry order (row, d, lane)) -> the
    port's slot layout (N * D, 4) u32, slot d of splat s at s * D + d."""
    e = np.stack([np.asarray(p, np.uint32) for p in planes], axis=-1)
    e = e.reshape(-1, d, 128, 4).transpose(0, 2, 1, 3).reshape(-1, d, 4)
    return np.ascontiguousarray(e[:n].reshape(-1, 4))


# (compression index in ALL_COMPRESSIONS, SH degree, display mode, max_dup);
# index 5 = norm8 + half (the default), 3 = half + half, 0 = single + single,
# 6 = remove + single, 2 = half + single.
CASES = [(5, 3, 0, 4), (5, 3, 0, 8), (3, 2, 0, 4), (0, 1, 1, 8), (6, 0, 2, 4), (2, 3, 1, 4)]


@pytest.mark.parametrize("ci,deg,mode,d", CASES,
                         ids=[f"c{c}-deg{g}-mode{m}-d{d}" for c, g, m, d in CASES])
def test_frontend_matches_jax_kernel(ci, deg, mode, d):
    """Plain port front-end vs the JAX Pallas front-end (interpret mode)."""
    jc, tc, rows, pod, view, proj = _scene(ci)
    n = pod["color0"].shape[0]
    jcfg = jbin.TileConfig(W, H, tile=16, max_dup=d)
    cfg = TileConfig(W, H, tile=16, max_dup=d)
    ref = j_enumerate_fused({k: jnp.asarray(v) for k, v in rows.items()}, jc, jcfg,
                            jnp.asarray(view), jnp.asarray(proj), jnp.eye(4), sh_degree=deg,
                            display_mode=mode, interpret=True)
    ref = _jax_fused_to_slots(ref, n, d)
    got = enumerate_entries_fused(pod, tc, cfg, view, proj, np.eye(4, dtype=np.float32),
                                  sh_degree=deg, display_mode=mode)
    assert got.shape == (n * d, 4) and got.dtype == torch.int32
    stats = compare_entries(got, ref, cfg)
    assert stats["live_a"] > n // 4, stats  # the scene is mostly on screen


def _jax_pre(comp_index, deg, mode):
    jc, tc, rows, pod, view, proj = _scene(comp_index, n=1500, seed=8)
    jpre = j_preprocess({k: jnp.asarray(v) for k, v in rows.items()}, jc, jnp.asarray(view),
                        jnp.asarray(proj), jnp.eye(4), W, H, sh_degree=deg, display_mode=mode)
    n = pod["color0"].shape[0]
    return jc, tc, pod, view, proj, jpre, n


@pytest.mark.parametrize("ci,deg,mode", [(5, 3, 0), (1, 2, 1), (7, 0, 2)])
def test_preprocess_matches_jax(ci, deg, mode):
    """Port preprocess vs the JAX preprocess: fields at rtol 1e-5, validity
    equal except where a quantity sits an ulp from a cull threshold."""
    jc, tc, pod, view, proj, jpre, n = _jax_pre(ci, deg, mode)
    pre = preprocess(pod, tc, view, proj, np.eye(4, dtype=np.float32), W, H, sh_degree=deg,
                     display_mode=mode)
    valid_j = np.asarray(jpre.valid)[:n]
    valid_t = pre.valid.numpy()
    assert (valid_j == valid_t).mean() > 0.999
    both = valid_j & valid_t
    for name in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "col_r", "col_g",
                 "col_b", "alpha", "depth"):
        np.testing.assert_allclose(getattr(pre, name).numpy()[both],
                                   np.asarray(getattr(jpre, name))[:n][both],
                                   rtol=1e-5, atol=2e-6, err_msg=name)
    rj, rt = np.asarray(jpre.radius)[:n][both], pre.radius.numpy()[both]
    np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [4, 16])
def test_enumeration_matches_jax_on_same_pre(d):
    """Enumeration + packing alone, fed the JAX PreprocessOut: the port and
    JAX `enumerate_entries_from_pre(impl="jnp")` agree slot for slot."""
    jc, tc, pod, view, proj, jpre, n = _jax_pre(5, 3, 0)
    jcfg = jbin.TileConfig(W, H, tile=16, max_dup=d)
    cfg = TileConfig(W, H, tile=16, max_dup=d)
    ref = jbin.enumerate_entries_from_pre(jpre, jcfg, impl="jnp")
    # jnp order is (D, N): slot d of splat s at d * N + s.
    ref = np.stack([np.asarray(p, np.uint32) for p in ref], axis=-1)
    n_pad = ref.shape[0] // d
    ref = ref.reshape(d, n_pad, 4).transpose(1, 0, 2)[:n].reshape(-1, 4)
    pre = PreprocessOut(**{f: torch.from_numpy(np.asarray(getattr(jpre, f))[:n].copy())
                           for f in PreprocessOut.__dataclass_fields__})
    got = enumerate_entries_from_pre(pre, cfg)
    stats = compare_entries(got, ref, cfg)
    assert stats["identical"] > 0.9995, stats


def test_gating_inputs_raise():
    _, tc, _, pod, view, proj = _scene(5, n=256)
    cfg = TileConfig(W, H, tile=16, max_dup=4)
    for kw in ({"mask_bits": np.ones(256, np.uint8)},
               {"edit": (np.zeros(256), np.zeros((256, 3)), np.zeros((256, 4)))},
               {"selection_bits": np.ones(256, np.uint8), "highlight_rgba": np.ones(4)}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            enumerate_entries_fused(pod, tc, cfg, view, proj, np.eye(4, dtype=np.float32), **kw)
