"""Multi-model scenes of the port on the CPU against the JAX package: the
key layout with a model rank, the enumeration from a `PreprocessOut` (plain
version of kernel K5) against the JAX enumeration and its Pallas kernel in
interpret mode, the ranked front-end (plain version of K1), the merged frame
on both front-end routes against the JAX `MultiModelViewer`, `render_frame`,
and the viewer's setters (`set_compressions`, `resize`, streaming slots).

Inputs come from numpy seeds; the same arrays go through both packages.
Tolerances: entries under `compare_entries` (>= 99.9% of live slots
bit-identical, the rest within one step of every quantised field, stated in
`wgpu_3dgs_viewer_app_tpu_torch/testing.py`); images under the golden gate
`assert_golden_close`; merged against sequential blend max 3e-2, mean 1e-4
(the JAX package's own limits for that identity).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu.core import CameraOrbitControl as JCamera
from wgpu_3dgs_viewer_app_tpu.core import ModelTransform as JModelTransform
from wgpu_3dgs_viewer_app_tpu.core import edit as jedit
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.ops import binning as jbin
from wgpu_3dgs_viewer_app_tpu.ops.fused import enumerate_entries_fused as j_enumerate_fused
from wgpu_3dgs_viewer_app_tpu.ops.preprocess import preprocess as j_preprocess
from wgpu_3dgs_viewer_app_tpu.viewer import MultiModelViewer as JMultiModelViewer
from wgpu_3dgs_viewer_app_tpu.viewer.viewer import render_frame as j_render_frame
from wgpu_3dgs_viewer_app_tpu_torch.convert import pod_from_jax, viewer_from_scene
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl, ModelTransform
from wgpu_3dgs_viewer_app_tpu_torch.core import edit as tedit
from wgpu_3dgs_viewer_app_tpu_torch.data import compression as tcomp
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    PreprocessOut, TileConfig, enumerate_entries_from_pre, enumerate_entries_fused,
    over_background)
from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import DEPTH_LN_MAX, DEPTH_LN_MIN
from wgpu_3dgs_viewer_app_tpu_torch.testing import compare_entries
from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer, Viewer, render_frame

EYE = np.eye(4, dtype=np.float32)


def _u8(img):
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8).astype(np.int16)


# --- the key layout ---------------------------------------------------------


@pytest.mark.parametrize("size", [(1920, 1088, 32), (256, 256, 16)], ids=["1088p-t32", "256-t16"])
@pytest.mark.parametrize("m", range(4))
def test_tile_config_model_bits_matches_jax(size, m):
    """`v2_depth_bits`, `_tile_shift` and the depth scale follow the JAX
    TileConfig for every rank width."""
    w, h, tile = size
    cfg = TileConfig(w, h, tile=tile, max_dup=4, model_bits=m)
    jcfg = jbin.TileConfig(w, h, tile=tile, max_dup=4, model_bits=m)
    assert cfg.tile_bits == jcfg.tile_bits
    assert cfg.v2_depth_bits == jcfg.v2_depth_bits
    assert cfg._tile_shift == jcfg._tile_shift
    assert cfg._rank_shift == jcfg.v2_depth_bits + jcfg.ALPHA_BITS
    assert cfg.depth_scale == float(2 ** jcfg.v2_depth_bits - 1) / (jbin.DEPTH_LN_MAX
                                                                    - jbin.DEPTH_LN_MIN)
    assert (DEPTH_LN_MIN, DEPTH_LN_MAX) == (jbin.DEPTH_LN_MIN, jbin.DEPTH_LN_MAX)


def test_tile_config_too_few_depth_bits_raises_in_both():
    """4K at 8-px tiles leaves 7 depth bits; two rank bits leave 5 < 6."""
    for cls in (TileConfig, jbin.TileConfig):
        assert cls(3840, 2160, tile=8, max_dup=4, model_bits=1).v2_depth_bits == 6
        with pytest.raises(ValueError, match="depth bits"):
            cls(3840, 2160, tile=8, max_dup=4, model_bits=2).v2_depth_bits
    with pytest.raises(ValueError, match="model_rank"):
        enumerate_entries_from_pre(_empty_pre(), TileConfig(64, 64, model_bits=1), model_rank=2)


def _empty_pre():
    z = torch.zeros(0)
    return PreprocessOut(*([z] * 11), valid=torch.zeros(0, dtype=torch.bool))


# --- enumeration from a PreprocessOut, with a rank --------------------------

W = H = 128
D = 4
CFG_M = TileConfig(W, H, tile=16, max_dup=D, model_bits=2)
JCFG_M = jbin.TileConfig(W, H, tile=16, max_dup=D, model_bits=2)


@pytest.fixture(scope="module")
def scene():
    """One model: the JAX rows pod, the same words for the port, a camera."""
    jc, tc = jcomp.ALL_COMPRESSIONS[5], tcomp.ALL_COMPRESSIONS[5]
    g = make_random_scene(1500, seed=8, extent=1.2, scale_range=(0.01, 0.05))
    rows = jcomp.pack_gaussians(g, jc, use_native=False)
    cam = JCamera(target=(0, 0, 0), pos=(0.3, 0.2, -4))
    return dict(jc=jc, tc=tc, rows={k: jnp.asarray(v) for k, v in rows.items()},
                pod=pod_from_jax(rows, tc, "cpu", n=g.count), n=g.count,
                view=cam.view(), proj=cam.projection(W / H))


@pytest.fixture(scope="module")
def shared_pre(scene):
    """One JAX PreprocessOut and the same planes as the port's, for every
    enumeration case."""
    s = scene
    jpre = j_preprocess(s["rows"], s["jc"], jnp.asarray(s["view"]), jnp.asarray(s["proj"]),
                        jnp.eye(4), W, H, sh_degree=3)
    pre = PreprocessOut(**{f: torch.from_numpy(np.asarray(getattr(jpre, f))[:s["n"]].copy())
                           for f in PreprocessOut.__dataclass_fields__})
    return jpre, pre


def _slots(planes, n, d, order):
    """JAX entry planes -> the port's (N * D, 4) slot layout. `order`:
    "dn" for the jnp enumeration ((D, N)-major), "rdl" for the Pallas
    kernels ((row, d, lane))."""
    e = np.stack([np.asarray(p, np.uint32) for p in planes], axis=-1)
    if order == "dn":
        e = e.reshape(d, -1, 4).transpose(1, 0, 2)
    else:
        e = e.reshape(-1, d, 128, 4).transpose(0, 2, 1, 3).reshape(-1, d, 4)
    return np.ascontiguousarray(e[:n].reshape(-1, 4))


@pytest.mark.parametrize("rank", [0, 2])
@pytest.mark.parametrize("impl", ["jnp", "interpret"])
def test_enumeration_with_rank_matches_jax(scene, shared_pre, impl, rank):
    """Plain K5 vs the JAX enumeration on the same PreprocessOut: the jnp
    path and the Pallas kernel `_enum_pack_kernel` in interpret mode, slot
    for slot under `compare_entries`; every live key carries the rank."""
    jpre, pre = shared_pre
    n = scene["n"]
    ref = jbin.enumerate_entries_from_pre(jpre, JCFG_M, impl=impl, model_rank=rank)
    ref = _slots(ref, n, D, "dn" if impl == "jnp" else "rdl")
    got = enumerate_entries_from_pre(pre, CFG_M, model_rank=rank)
    assert got.shape == (n * D, 4) and got.dtype == torch.int32
    stats = compare_entries(got, ref, CFG_M)
    assert stats["live_a"] > n // 4 and stats["identical"] > 0.9995, stats
    keys = got[:, 0].numpy().view(np.uint32)
    live = keys != 0xFFFFFFFF
    assert ((keys[live] >> CFG_M._rank_shift) & 3 == rank).all()
    assert np.array_equal(keys[live], ref[:, 0][live])  # same PreprocessOut: keys bit-equal


def test_fused_frontend_with_rank_matches_jax_kernel(scene):
    """Plain K1 with a model rank vs the JAX Pallas front-end in interpret
    mode with the same rank: `compare_entries`, and the rank in every key."""
    s, rank = scene, 1
    ref = j_enumerate_fused(s["rows"], s["jc"], JCFG_M, jnp.asarray(s["view"]),
                            jnp.asarray(s["proj"]), jnp.eye(4), interpret=True, model_rank=rank)
    got = enumerate_entries_fused(s["pod"], s["tc"], CFG_M, s["view"], s["proj"], EYE,
                                  model_rank=rank)
    stats = compare_entries(got, _slots(ref, s["n"], D, "rdl"), CFG_M)
    assert stats["live_a"] > s["n"] // 4, stats
    keys = got[:, 0].numpy().view(np.uint32)
    assert ((keys[keys != 0xFFFFFFFF] >> CFG_M._rank_shift) & 3 == rank).all()
    out = torch.empty_like(got)  # writing into a given buffer gives the same entries
    assert enumerate_entries_fused(s["pod"], s["tc"], CFG_M, s["view"], s["proj"], EYE,
                                   model_rank=rank, out=out) is out and torch.equal(out, got)


# --- the merged frame -------------------------------------------------------

MW, MH = 128, 96
PLACEMENTS = ((-1.0, 0.0), (0.0, 40.0), (1.0, -40.0))  # config 2's layout, scaled down
MCAM = dict(target=(0, 0, 0), pos=(0, 0, -4.5))


def _jax_viewer(gaussians, placements):
    """A JAX viewer (`use_pallas=False`) of the given models, each placed at
    (x, y rotation, z) with a per-splat colour edit."""
    jv = JMultiModelViewer(MW, MH, tile=16, max_dup=4, use_pallas=False)
    for i, (g, (dx, rot, dz)) in enumerate(zip(gaussians, placements)):
        m = jv.add_model(f"m{i}", g)
        jv.update_model_transform(f"m{i}", JModelTransform(
            pos=np.array([dx, 0.0, dz], np.float32), rot=np.array([0.0, rot, 0.0], np.float32)))
        n = m.buffers.edit_flags.shape[0]
        m.buffers.set_edits(np.full(n, jedit.EDIT_FLAG_ENABLED, np.uint32),
                            np.broadcast_to(np.float32([0.08 * i, 1.1, 1.0]), (n, 3)),
                            np.asarray(m.buffers.edit_params))
    return jv


def _scene_data(jv):
    """The JAX viewer's merged frame, its model order, and its models as the
    plain data `viewer_from_scene` takes."""
    ref = np.asarray(jv.render(JCamera(**MCAM)))
    models = []
    for key, m in jv.models.items():
        b = m.buffers
        models.append(dict(
            name=key, pod={k: np.asarray(v) for k, v in b.pod.items()}, count=len(b),
            pos=m.transform.pos, rot=m.transform.rot, scale=m.transform.scale,
            visible=m.visible, center=m.center,
            edits=(np.asarray(b.edit_flags), np.asarray(b.edit_rgb), np.asarray(b.edit_params))))
    return dict(ref=ref, models=models, order=jv.model_order())


@pytest.fixture(scope="module")
def jax_scene():
    """Config 2 scaled down on the JAX viewer: three 2k-splat models side by
    side with y rotations and a per-splat colour edit each; the merged
    reference frame; and the scene as plain data for the port."""
    return _scene_data(_jax_viewer(
        [make_random_scene(2000, seed=i, extent=1.2, scale_range=(0.01, 0.04)) for i in range(3)],
        [(dx, rot, 0.0) for dx, rot in PLACEMENTS]))


@pytest.fixture(scope="module")
def dense_scene():
    """A scene dense in depth, as a large cloud is per pixel: three 2k-splat
    models squeezed into slabs 0.004 thick that face the camera and overlap.
    A slab spans about 4 steps of the 16-bit depth key of the merged layout
    and about 18 of the single-model layout's 18 bits, so splats that tie in
    depth merged are ordered when a model is drawn alone. Besides the merged
    JAX frame, the JAX viewer's own `render_model` frames blended back to
    front."""
    gs = []
    for i in range(3):
        g = make_random_scene(2000, seed=i, extent=1.0, scale_range=(0.02, 0.05))
        gs.append(dataclasses.replace(g, pos=g.pos * np.float32([1.0, 1.0, 0.002])))
    jv = _jax_viewer(gs, [(-0.3, 0.0, 0.0), (0.0, 0.0, 0.002), (0.3, 0.0, 0.004)])
    data = _scene_data(jv)
    acc = None
    for key in data["order"]:
        img = np.asarray(jv.render_model(key))
        acc = img if acc is None else img + (1.0 - img[..., 3:4]) * acc
    data["blend"] = acc[..., :3] + (1.0 - acc[..., 3:4]) * np.asarray(jv.background, np.float32)
    return data


def _port_viewer(jax_scene, fused):
    v = viewer_from_scene(jax_scene["models"], MW, MH, tcomp.ALL_COMPRESSIONS[5], device="cpu",
                          tile=16, max_dup=4, fused=fused)
    v.update_camera(CameraOrbitControl(**MCAM))
    return v


def _sequential(v, order, cfg=None):
    """Per-model frames blended back to front with "over": `render_model`,
    or, with `cfg`, each model alone under that (merged) key layout."""
    acc = None
    for key in order:
        img = (v.render_model(key) if cfg is None
               else v._composite(v._model_entries(key, cfg, 0, False), cfg))
        acc = img if acc is None else img + (1.0 - img[..., 3:4]) * acc
    return over_background(acc, v.background)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_merged_frame_matches_jax_viewer(jax_scene, fused):
    """Three models merged by rank in the key, on either front-end route,
    vs the JAX MultiModelViewer (`use_pallas=False`): the golden gate. The
    port's viewer is built from the JAX viewer's arrays."""
    v = _port_viewer(jax_scene, fused)
    assert v.model_order() == jax_scene["order"]
    assert all(m.buffers.edit_flags is not None for m in v.models.values())
    got = v.render()
    assert got.shape == (MH, MW, 3) and got.dtype == torch.float32
    assert float(got.amax(dim=-1).gt(0.02).float().mean()) > 0.2
    assert_golden_close(_u8(got.numpy()), _u8(jax_scene["ref"]))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_merged_equals_sequential_blend(jax_scene, fused):
    """One sort and one composite with ranks = per-model frames blended back
    to front: against `render_model` max 3e-2, mean 1e-4 (its keys have two
    more depth bits, so depth ties may blend in another order); against the
    models drawn alone under the merged key layout max 1e-4 (only the
    summation order differs). The two routes agree under the golden gate."""
    v = _port_viewer(jax_scene, fused)
    merged = v.render()
    order = v.model_order()
    diff = (merged - _sequential(v, order)).abs()
    assert float(diff.max()) < 3e-2 and float(diff.mean()) < 1e-4
    assert float((merged - _sequential(v, order, v.merged_config(3))).abs().max()) < 1e-4
    other = _port_viewer(jax_scene, not fused).render()
    assert_golden_close(_u8(merged.numpy()), _u8(other.numpy()))


def test_dense_scene_merged_matches_jax_and_misses_blend_limits_in_both(dense_scene):
    """Where depth ties are common the merged frame drifts from the blend of
    the `render_model` frames beyond max 3e-2 / mean 1e-4, and that is the
    key layout's cost, not the port's: the JAX viewer's merged frame misses
    its own blend by the same amount (within 1e-3 of the port's maximum and
    mean), the port's merged frame equals the JAX merged frame under the
    golden gate, and under one key layout the identity holds to 4/255 (a
    pixel's blending stops where its transmittance falls under 1/255: alone
    by the model's own, merged by the product of all nearer models', so each
    of the four images may lack up to 1/255)."""
    v = _port_viewer(dense_scene, True)
    merged = v.render()
    order = v.model_order()
    assert order == dense_scene["order"]
    assert_golden_close(_u8(merged.numpy()), _u8(dense_scene["ref"]))
    d_jax = np.abs(dense_scene["ref"] - dense_scene["blend"])
    d_port = (merged - _sequential(v, order)).abs().numpy()
    for d in (d_jax, d_port):
        assert d.max() > 3e-2 and d.mean() > 1e-4, (d.max(), d.mean())
    assert abs(d_jax.max() - d_port.max()) < 1e-3 and abs(d_jax.mean() - d_port.mean()) < 1e-3
    assert float((merged - _sequential(v, order, v.merged_config(3))).abs().max()) < 4.0 / 255.0


def test_hidden_model_and_order_flip(jax_scene):
    """Hiding the middle model narrows the rank field to one bit and changes
    the frame; moving the farthest model in front flips the order, the ranks
    and the frame, and the merged frame still equals the sequential blend."""
    v = _port_viewer(jax_scene, True)
    full = v.render()
    order = v.model_order()
    assert len(order) == 3 and v.merged_config(3).model_bits == 2
    v.models["m1"].visible = False
    two = v.render()
    assert v.model_order() == [k for k in order if k != "m1"]
    assert v.merged_config(len(v.model_order())).model_bits == 1
    assert float((two - full).abs().max()) > 0.05
    v.models["m1"].visible = True

    far = order[0]
    v.update_model_transform(far, dataclasses.replace(
        v.models[far].transform, pos=np.float32([0.0, 0.0, -2.0])))
    flipped = v.model_order()
    assert flipped[-1] == far and flipped != order
    entries, cfg_m = v.merged_entries(flipped)
    keys = entries[:, 0].numpy().view(np.uint32)
    start = 0
    for i, key in enumerate(flipped):  # model i of the back-to-front order: rank n - 1 - i
        rows = v.models[key].buffers.capacity * cfg_m.max_dup
        k = keys[start:start + rows]
        k = k[k != 0xFFFFFFFF]
        assert k.size and ((k >> cfg_m._rank_shift) & 3 == len(flipped) - 1 - i).all()
        start += rows
    moved = v.render()
    assert float((moved - full).abs().max()) > 0.05
    assert float((moved - _sequential(v, flipped, cfg_m)).abs().max()) < 1e-4


# --- render_frame -----------------------------------------------------------


def test_render_frame_matches_jax(scene):
    """The staged single-model pipeline with a mask and per-splat edits vs
    the JAX `render_frame(use_pallas=False)`: the golden gate."""
    s, n = scene, scene["n"]
    n_pad = s["rows"]["pos"].shape[-2] * 128
    rng = np.random.default_rng(4)
    mask = np.ones(n_pad, np.uint8)
    mask[:n] = rng.random(n) > 0.25
    flags, ergb, eprm = jedit.make_edit_soa(n_pad)
    flags[:n] = rng.choice(np.uint32([0, 1, 1, 3, 5]), n)
    ergb[:n] = rng.uniform([-1.0, 0.5, 0.5], [1.0, 1.5, 1.5], (n, 3))
    eprm[:n] = rng.uniform([-0.3, -0.5, 0.5, 0.3], [0.3, 0.5, 2.0, 1.0], (n, 4))
    jcfg, cfg = jbin.TileConfig(W, H, tile=16, max_dup=8), TileConfig(W, H, tile=16, max_dup=8)
    ref = j_render_frame(s["rows"], s["jc"], jcfg, jnp.asarray(s["view"]), jnp.asarray(s["proj"]),
                         jnp.eye(4), jnp.float32(1.0), 3, False, 0, jnp.asarray(mask),
                         (jnp.asarray(flags), jnp.asarray(ergb), jnp.asarray(eprm)), None, None,
                         None, False, False)
    got = render_frame(s["pod"], s["tc"], cfg, s["view"], s["proj"], EYE,
                       mask_bits=torch.from_numpy(mask[:n]),
                       edit=(torch.from_numpy(flags[:n].view(np.int32)),
                             torch.from_numpy(ergb[:n]), torch.from_numpy(eprm[:n])))
    assert got.shape == (H, W, 4) and float(got[..., 3].mean()) > 0.05
    assert_golden_close(_u8(got.numpy()), _u8(ref))
    ungated = render_frame(s["pod"], s["tc"], cfg, s["view"], s["proj"], EYE)
    assert float((got - ungated).abs().max()) > 0.1


# --- the viewer's setters ---------------------------------------------------


def _two_viewers(n=600):
    g = make_random_scene(n, seed=21, extent=1.0, scale_range=(0.02, 0.06))
    jv = JMultiModelViewer(96, 64, tile=16, max_dup=4, use_pallas=False)
    tv = MultiModelViewer(96, 64, tile=16, max_dup=4, device="cpu")
    return g, jv, tv


def _pods_equal(jb, tb, comp):
    """The JAX buffers' pod against the port's: every field word for word,
    but the covariance within one f16 step (one f32 ulp where uncompressed)
    on at most 0.5% of its words: the JAX buffers pack through the package's
    native codec where it is built, which rounds the covariance products in
    another order than the numpy codec the port's pack is byte-equal to."""
    ref = pod_from_jax({k: np.asarray(v) for k, v in jb.pod.items()}, comp, "cpu", n=tb.capacity)
    assert set(ref) == set(tb.pod)
    for k in ref:
        a, b = ref[k].numpy(), tb.pod[k].numpy()
        if k != "cov3d":
            assert np.array_equal(a, b), k
            continue
        if a.dtype == np.int32:  # two f16 per word
            a, b = (x.view(np.uint32).astype(np.int64) for x in (a, b))
            step = np.maximum(np.abs((a & 0xFFFF) - (b & 0xFFFF)), np.abs((a >> 16) - (b >> 16)))
        else:
            step = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))
        assert step.max() <= 1 and (step > 0).mean() <= 0.005, (k, step.max(), (step > 0).mean())
    return True


def test_set_compressions_repacks_and_keeps_edit_state():
    """`set_compressions` on both viewers: the re-packed pods are equal
    (`_pods_equal`), the edits, selection and mask carry over, a gate never set
    stays unset, and the frame stays within the golden gate of the first."""
    g, jv, tv = _two_viewers()
    rng = np.random.default_rng(2)
    sel, mask = rng.random(g.count) < 0.5, rng.random(g.count) < 0.8
    for v, mod in ((jv, jedit), (tv, tedit)):
        b = v.add_model("m", g).buffers
        b.set_selection(sel.astype(np.uint8))
        b.commit_selection_edit(mod.EDIT_FLAG_ENABLED, (0.3, 1.2, 0.9), (0.1, 0.2, 1.1, 0.8))
        v.add_model("plain", g)
    tv.models["m"].buffers.set_mask(mask.astype(np.uint8))
    jv.models["m"].buffers.set_mask(mask.astype(np.uint8))
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    tv.models["plain"].visible = False
    first = tv.render(cam)
    old_flags = tv.models["m"].buffers.edit_flags
    new = 1  # single SH, half cov3d
    jv.set_compressions(jcomp.ALL_COMPRESSIONS[new])
    tv.set_compressions(tcomp.ALL_COMPRESSIONS[new])
    assert tv.comp == tcomp.ALL_COMPRESSIONS[new]
    for key in ("m", "plain"):
        jb, tb = jv.models[key].buffers, tv.models[key].buffers
        assert tb.comp == tv.comp and len(tb) == len(jb) == g.count
        assert _pods_equal(jb, tb, tv.comp), key
        for a, b in zip(jb.download_edits(), tb.download_edits()):
            assert np.array_equal(a, b)
        assert np.array_equal(jb.download_selection(), tb.download_selection())
        assert np.array_equal(jb.download_mask(), tb.download_mask())
    assert tv.models["m"].buffers.edit_flags is old_flags
    plain = tv.models["plain"].buffers
    assert plain.edit_flags is None and plain.selection is None and plain.mask is None
    again = tv.render()
    assert_golden_close(_u8(again.numpy()), _u8(first.numpy()))
    assert not torch.equal(again, tv.render(show_unedited=True))  # the edits still act


def test_resize_matches_fresh_viewer():
    """`resize` gives both viewers the same new tiling, and the port renders
    what a viewer built at that size renders."""
    g, jv, tv = _two_viewers()
    jv.add_model("m", g)
    tv.add_model("m", g)
    jv.resize(80, 48)
    tv.resize(80, 48)
    for f in ("width", "height", "tile", "max_dup", "tiles_x", "tiles_y", "_tile_shift"):
        assert getattr(tv.cfg, f) == getattr(jv.cfg, f), f
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    img = tv.render(cam)
    assert img.shape == (48, 80, 3)
    assert torch.equal(img, Viewer(g, 80, 48, tile=16, max_dup=4, device="cpu").render(cam))


def test_streaming_slot_matches_jax_buffers():
    """`add_empty_model` then two `update_range` chunks: an empty slot is
    not drawn, the streamed pod equals the JAX viewer's word for word, and
    pod and the frame equal the one-upload pod and frame."""
    g, jv, tv = _two_viewers()
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    jm, tm = jv.add_empty_model("s", 1000), tv.add_empty_model("s", 1000)
    assert tm.file_name == jm.file_name == "s" and len(tm.buffers) == 0
    assert tv.model_order() == jv.model_order() == []
    assert float(tv.render(cam).abs().max()) == 0.0
    for start, stop in ((0, 250), (250, g.count)):
        jm.buffers.update_range(start, g.slice(start, stop))
        tm.buffers.update_range(start, g.slice(start, stop))
    assert len(tm.buffers) == len(jm.buffers) == g.count
    assert tv.model_order() == jv.model_order() == ["s"]
    assert _pods_equal(jm.buffers, tm.buffers, tv.comp)
    whole = MultiModelViewer(96, 64, tile=16, max_dup=4, device="cpu")
    whole.add_model("s", g, capacity=1000)
    assert all(torch.equal(v, tm.buffers.pod[k]) for k, v in whole.models["s"].buffers.pod.items())
    assert torch.equal(tv.render(), whole.render(cam))
    assert tv.add_empty_model("s", 10).file_name == "s (1)"
