"""Port front-end (plain version of kernel K1: preprocess + enumerate/pack)
and query-geometry pass (plain version of kernel K4) against the JAX
package: the Pallas front-end and geometry kernels in interpret mode, the
JAX preprocess, and the JAX enumeration on the same PreprocessOut, each
ungated and with the gates (mask bits, per-splat edit, selection edit and
highlight) made from the same numpy seed.

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

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene as j_make_random_scene
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.core import edit as jedit
from wgpu_3dgs_viewer_app_tpu.ops.fused import enumerate_entries_fused as j_enumerate_fused
from wgpu_3dgs_viewer_app_tpu.ops.fused import preprocess_geometry_fused as j_geometry
from wgpu_3dgs_viewer_app_tpu.ops.preprocess import preprocess as j_preprocess
from wgpu_3dgs_viewer_app_tpu_torch.convert import pod_from_jax
from wgpu_3dgs_viewer_app_tpu_torch.core import edit as tedit
from wgpu_3dgs_viewer_app_tpu_torch.data import compression as tcomp
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    PreprocessOut, TileConfig, enumerate_entries_from_pre, enumerate_entries_fused, preprocess,
    preprocess_geometry_fused)
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


# --- gates: mask bits, per-splat edit, selection edit + highlight ---------

SEL_EDIT = tedit.GaussianEditPod(tedit.EDIT_FLAG_ENABLED, (0.15, 1.2, 1.0), 0.1, 0.2, 1.0, 0.8)
HIGHLIGHT = np.float32([1.0, 0.0, 1.0, 0.4])
GATE_SETS = {"mask": ("mask",), "edit": ("edit",), "sel": ("sel_edit", "highlight"),
             "all": ("mask", "edit", "sel_edit", "highlight")}


def _gates(n, n_pad, which, seed=3):
    """The same gates for both sides, from one numpy seed: JAX kwargs at the
    padded length (mask pads with 1, the rest with identity), port kwargs
    as tensors at n (the dtypes the kernels read)."""
    rng = np.random.default_rng(seed)
    mask = np.ones(n_pad, np.uint8)
    mask[:n] = rng.random(n) > 0.25
    sel = np.zeros(n_pad, np.uint8)
    sel[:n] = rng.random(n) > 0.5
    flags, ergb, eprm = jedit.make_edit_soa(n_pad)
    flags[:n] = rng.choice(np.uint32([0, 1, 1, 3, 5]), n)  # off, on, hidden, override
    ergb[:n] = rng.uniform([-1.0, 0.5, 0.5], [1.0, 1.5, 1.5], (n, 3))
    eprm[:n] = rng.uniform([-0.3, -0.5, 0.5, 0.3], [0.3, 0.5, 2.0, 1.0], (n, 4))
    jkw, tkw = {}, {}
    if "mask" in which:
        jkw["mask_bits"], tkw["mask_bits"] = jnp.asarray(mask), torch.from_numpy(mask[:n])
    if "edit" in which:
        jkw["edit"] = (jnp.asarray(flags), jnp.asarray(ergb), jnp.asarray(eprm))
        tkw["edit"] = (torch.from_numpy(flags[:n].view(np.int32)), torch.from_numpy(ergb[:n]),
                       torch.from_numpy(eprm[:n]))
    if "sel_edit" in which or "highlight" in which:
        jkw["selection_bits"], tkw["selection_bits"] = jnp.asarray(sel), torch.from_numpy(sel[:n])
    if "sel_edit" in which:
        jkw["selection_edit"] = tuple(jnp.asarray(x) for x in SEL_EDIT.as_arrays())
        tkw["selection_edit"] = SEL_EDIT.as_arrays()
    if "highlight" in which:
        jkw["highlight_rgba"], tkw["highlight_rgba"] = jnp.asarray(HIGHLIGHT), HIGHLIGHT
    return jkw, tkw


@pytest.mark.parametrize("name", list(GATE_SETS))
def test_gated_preprocess_matches_jax(name):
    """Gated port preprocess vs the gated JAX preprocess: validity >= 99.9%
    equal; fields at rtol 1e-5 (atol 2e-6) where both are valid."""
    jc, tc, rows, pod, view, proj = _scene(5, n=1200, seed=9)
    n = pod["color0"].shape[0]
    jkw, tkw = _gates(n, rows["pos"].shape[-2] * 128, GATE_SETS[name])
    jpre = j_preprocess({k: jnp.asarray(v) for k, v in rows.items()}, jc, jnp.asarray(view),
                        jnp.asarray(proj), jnp.eye(4), W, H, sh_degree=3, **jkw)
    pre = preprocess(pod, tc, view, proj, np.eye(4, dtype=np.float32), W, H, sh_degree=3, **tkw)
    valid_j, valid_t = np.asarray(jpre.valid)[:n], pre.valid.numpy()
    assert (valid_j == valid_t).mean() >= 0.999
    assert valid_t.sum() > n // 4
    both = valid_j & valid_t
    for f in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "col_r", "col_g", "col_b",
              "alpha", "depth", "radius"):
        np.testing.assert_allclose(getattr(pre, f).numpy()[both],
                                   np.asarray(getattr(jpre, f))[:n][both],
                                   rtol=1e-5, atol=2e-6 if f != "radius" else 1e-4, err_msg=f)


@pytest.mark.parametrize("name", ["all"])
def test_gated_frontend_matches_jax_kernel(name):
    """Gated plain K1 vs the JAX Pallas front-end (interpret mode) with the
    same gates, all four at once: `compare_entries`."""
    jc, tc, rows, pod, view, proj = _scene(5, n=1024, seed=6)
    n = pod["color0"].shape[0]
    jkw, tkw = _gates(n, rows["pos"].shape[-2] * 128, GATE_SETS[name], seed=4)
    cfg, jcfg = TileConfig(W, H, tile=16, max_dup=4), jbin.TileConfig(W, H, tile=16, max_dup=4)
    ref = j_enumerate_fused({k: jnp.asarray(v) for k, v in rows.items()}, jc, jcfg,
                            jnp.asarray(view), jnp.asarray(proj), jnp.eye(4), interpret=True, **jkw)
    got = enumerate_entries_fused(pod, tc, cfg, view, proj, np.eye(4, dtype=np.float32), **tkw)
    stats = compare_entries(got, _jax_fused_to_slots(ref, n, 4), cfg)
    assert stats["live_a"] > n // 4, stats


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_geometry_matches_jax_kernel(mode, gated):
    """Plain K4 (`preprocess_geometry_fused` on the CPU) vs the JAX geometry
    kernel in interpret mode: validity >= 99.9% equal, fields at rtol/atol
    2e-5 (the JAX kernel derives proj[0][0] as 2 fx / width)."""
    jc, tc, rows, pod, view, proj = _scene(3, n=700, seed=21)
    n = pod["color0"].shape[0]
    jkw, tkw = _gates(n, rows["pos"].shape[-2] * 128, ("mask", "edit") if gated else (), seed=2)
    ref = j_geometry({k: jnp.asarray(v) for k, v in rows.items()}, jc, jnp.asarray(view),
                     jnp.asarray(proj), jnp.eye(4), W, H, display_mode=mode, interpret=True, **jkw)
    got = preprocess_geometry_fused(pod, tc, view, proj, np.eye(4, dtype=np.float32), W, H,
                                    display_mode=mode, **tkw)
    valid_j, valid_t = np.asarray(ref.valid)[:n], got.valid.numpy()
    assert got.valid.dtype == torch.bool and (valid_j == valid_t).mean() >= 0.999
    both = valid_j & valid_t
    assert both.sum() > n // 4
    for f in PreprocessOut.__dataclass_fields__:
        np.testing.assert_allclose(getattr(got, f).numpy()[both],
                                   np.asarray(getattr(ref, f))[:n][both],
                                   rtol=2e-5, atol=2e-5, err_msg=f)
