"""The staged front-end's preprocess on the CPU: `ops.preprocess_fused`
(kernel K8 on the card, the plain `preprocess` on the CPU) against the JAX
`preprocess` over every compression, SH degree, display mode and gate set;
the host-side packing of the frame and int params and the pointers that
K8's and K4's launcher is handed, for each gate code (a stand-in library
records the call); the staged callers (`render_frame`, the viewer's
`fused=False` route, the sharded renderer) reach `preprocess_fused` and
launch nothing on the CPU; and the sharded frame on one gloo rank equals
`render_frame` bit for bit.

Tolerances are `tests/test_torch_frontend.py`'s against the JAX preprocess:
validity equal on >= 99.9% of the splats; where both are valid, fields at
rtol 1e-5 and atol 2e-6 (radius atol 1e-4), since XLA:CPU and torch round
their transcendentals an ulp apart. On the CPU `preprocess_fused` IS the
plain version: its fields equal `preprocess`'s exactly. No JAX
interpret-mode Pallas call runs here; every scene is at most 2,048 splats.
"""

import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from test_torch_frontend import GATE_SETS, HIGHLIGHT, SEL_EDIT, H, W, _gates, _scene
from wgpu_3dgs_viewer_app_tpu.ops.preprocess import preprocess as j_preprocess
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.core.edit import EDIT_FLAG_ENABLED
from wgpu_3dgs_viewer_app_tpu_torch.data import (ALL_COMPRESSIONS, Compressions,
                                                 flat_pod_to_words, make_random_scene,
                                                 pack_gaussians, pod_to_tensors)
from wgpu_3dgs_viewer_app_tpu_torch.ops import (PreprocessOut, TileConfig, composite_tiles_v2,
                                                enumerate_entries_from_pre, kernels,
                                                over_background, preprocess, preprocess_fused,
                                                sort_entries)
from wgpu_3dgs_viewer_app_tpu_torch.ops import fused as tfused
from wgpu_3dgs_viewer_app_tpu_torch.ops.preprocess import frame_scalars
from wgpu_3dgs_viewer_app_tpu_torch.parallel import (make_mesh, render_frame_sharded_multi,
                                                     render_sharded, shard_pod)
from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer, render_frame
from wgpu_3dgs_viewer_app_tpu_torch.viewer import viewer as viewer_mod

# The module (the package exports its function of the same name).
sharded_mod = importlib.import_module("wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded")
EYE = np.eye(4, dtype=np.float32)
GATE_NAMES = [None, "mask", "edit", "sel", "all"]
# Every compression at every SH degree; the display mode and the gate set
# cycle over the cases, so each mode and gate set meets several of each.
CASES = [(ci, deg, (ci + deg) % 3, GATE_NAMES[(ci * 4 + deg) % len(GATE_NAMES)])
         for ci in range(len(ALL_COMPRESSIONS)) for deg in range(4)]


@pytest.mark.parametrize("ci,deg,mode,gate", CASES,
                         ids=[f"c{c}-deg{d}-mode{m}-{g or 'ungated'}" for c, d, m, g in CASES])
def test_preprocess_fused_matches_plain_and_jax(ci, deg, mode, gate):
    """On a CPU pod `preprocess_fused` equals the plain `preprocess` field
    for field, launches nothing, and meets the JAX preprocess."""
    jc, tc, rows, pod, view, proj = _scene(ci, n=1200, seed=9 + ci)
    n = pod["color0"].shape[0]
    jkw, tkw = _gates(n, rows["pos"].shape[-2] * 128, GATE_SETS[gate] if gate else ())
    args = (pod, tc, view, proj, EYE, W, H)
    kernels.reset_launch_counts()
    got = preprocess_fused(*args, sh_degree=deg, display_mode=mode, **tkw)
    assert not any(kernels.LAUNCHES.values())
    plain = preprocess(*args, sh_degree=deg, display_mode=mode, **tkw)
    for f in PreprocessOut.__dataclass_fields__:
        assert torch.equal(getattr(got, f), getattr(plain, f)), f
    jpre = j_preprocess({k: jnp.asarray(v) for k, v in rows.items()}, jc, jnp.asarray(view),
                        jnp.asarray(proj), jnp.eye(4), W, H, sh_degree=deg, display_mode=mode,
                        **jkw)
    valid_j, valid_t = np.asarray(jpre.valid)[:n], got.valid.numpy()
    assert (valid_j == valid_t).mean() >= 0.999
    assert valid_t.sum() > n // 4
    both = valid_j & valid_t
    for f in ("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "col_r", "col_g", "col_b",
              "alpha", "depth", "radius"):
        np.testing.assert_allclose(getattr(got, f).numpy()[both],
                                   np.asarray(getattr(jpre, f))[:n][both],
                                   rtol=1e-5, atol=2e-6 if f != "radius" else 1e-4, err_msg=f)


# --- the host-side packing of K8's (and K4's) launch -------------------------


class _Recorder:
    """Stands in for the kernel library: records each launcher's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0

        return launch


def _require_cpu(t, name, dtype, shape, device=None):
    """`kernels.require` without its CUDA check, for CPU tensors."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}")


# gate set -> (the gate kwargs it passes, its gate bits, whether the
# selection bits are handed to the kernel)
PACK_GATES = {
    "none": ((), 0, False),
    "mask": (("mask",), 1, False),
    "edit": (("edit",), 2, False),
    "sel_edit": (("sel_edit",), 4, True),
    "highlight": (("highlight",), 8, True),
    "sel_bits_alone": (("sel_bits",), 0, False),
    "all": (("mask", "edit", "sel_edit", "highlight"), 15, True),
}


def _cpu_gates(n, which, seed=3):
    rng = np.random.default_rng(seed)
    kw = {}
    if "mask" in which:
        kw["mask_bits"] = torch.from_numpy((rng.random(n) > 0.25).astype(np.uint8))
    if "edit" in which:
        kw["edit"] = (torch.from_numpy(rng.choice(np.int32([0, 1, 3, 5]), n)),
                      torch.from_numpy(rng.random((n, 3)).astype(np.float32)),
                      torch.from_numpy(rng.random((n, 4)).astype(np.float32)))
    if which & {"sel_edit", "highlight", "sel_bits"}:
        kw["selection_bits"] = torch.from_numpy((rng.random(n) > 0.5).astype(np.uint8))
    if "sel_edit" in which:
        kw["selection_edit"] = SEL_EDIT.as_arrays()
    if "highlight" in which:
        kw["highlight_rgba"] = HIGHLIGHT
    return kw


@pytest.mark.parametrize("ci", [5, 6], ids=["norm8-half", "remove-single"])
@pytest.mark.parametrize("name", list(PACK_GATES))
def test_preprocess_launch_params_packing(monkeypatch, ci, name):
    """What `gs_preprocess` is handed, for each gate code: the 15 int params
    (`csrc/splat.cuh::IntParams`), the 55 frame floats (`FrameParams`: the
    matrices, the projection scalars and the scene-wide selection edit and
    highlight at floats 44-54), and the pod, SH, gate and output pointers
    in the launcher's order; the PreprocessOut fields are the rows of the
    (11, N) output."""
    which, code, sel_given = PACK_GATES[name]
    comp = ALL_COMPRESSIONS[ci]
    n = 300
    g = make_random_scene(n, seed=1)
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), "cpu")
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.3, 0.2, -5))
    view, proj = cam.view(), cam.projection(640 / 480)
    model = EYE.copy()
    model[:3, 3] = (0.5, -0.25, 1.0)
    gates = _cpu_gates(n, set(which))
    lib = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require", _require_cpu)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    before = kernels.LAUNCHES["preprocess"]
    pre = tfused._planes_cuda("gs_preprocess", "preprocess", pod, comp, view, proj, model, 640,
                              480, 2, True, 1.5, 1, gates)
    assert kernels.LAUNCHES["preprocess"] == before + 1
    kernels.LAUNCHES["preprocess"] = before
    [(entry, args)] = lib.calls
    assert entry == "gs_preprocess" and len(args) == 16
    frame, iparams = list(args[0]), list(args[1])
    sh_code = {"norm8": 2, "remove": 3}[comp.sh.value]
    sel_flags = EDIT_FLAG_ENABLED if code & 4 else 0
    assert iparams == [n, sh_code, int(comp.cov3d.value == "half"), 2, 1, 1, 0, 0, 0, 0, 0, code,
                       sel_flags, 0, 0]
    f32 = lambda a: np.asarray(a, np.float32).ravel().tolist()  # noqa: E731
    fs = frame_scalars(view, proj, model, 640, 480, 1.5)
    assert frame[0:12] == f32(model[:3, :3]) + f32(model[:3, 3])
    assert frame[12:24] == f32(view[:3, :3]) + f32(view[:3, 3])
    assert frame[24:26] == f32([proj[0, 0], proj[1, 1]])
    assert frame[32:35] == [640.0, 480.0, fs["size2"]]
    assert frame[37:44] == f32(fs["cam"]) + f32([fs["z_near"], fs["z_far"], 0.0, 0.0])
    want_consts = [0.0] * 11
    if code & 4:
        _, rgb, params = SEL_EDIT.as_arrays()
        want_consts[:7] = f32(rgb) + f32(params)
    if code & 8:
        want_consts[7:] = f32(HIGHLIGHT)
    assert frame[44:55] == want_consts
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    sh = (ptr(pod["sh"]), ptr(pod["sh_mn"]), ptr(pod["sh_span"])) if ci == 5 else (None,) * 3
    edit = gates.get("edit", (None,) * 3)
    assert args[2:5] == (ptr(pod["pos"]), ptr(pod["color0"]), ptr(pod["cov3d"]))
    assert args[5:8] == sh
    assert args[8:13] == (ptr(gates.get("mask_bits")),
                          ptr(gates["selection_bits"]) if sel_given else None,
                          *(ptr(t) for t in edit))
    assert args[13] == pre.mean_x.data_ptr() and args[15] == 0
    assert args[14] == pre.valid.data_ptr() and pre.valid.dtype == torch.bool
    for i, f in enumerate(("mean_x", "mean_y", "conic_a", "conic_b", "conic_c", "col_r",
                           "col_g", "col_b", "alpha", "depth", "radius")):
        assert getattr(pre, f).data_ptr() == args[13] + 4 * n * i


def test_geometry_launch_params_packing(monkeypatch):
    """K4 through the same launcher: `gs_geometry`, SH degree 0, no SH
    pointers, the mask and edit gates only, and its own launch counter."""
    comp = ALL_COMPRESSIONS[5]
    n = 200
    pod = pod_to_tensors(flat_pod_to_words(pack_gaussians(make_random_scene(n, seed=2), comp),
                                           comp), "cpu")
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -5))
    gates = _cpu_gates(n, {"mask", "edit"})
    lib = _Recorder()
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(kernels, "require", _require_cpu)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    before = dict(kernels.LAUNCHES)
    tfused._planes_cuda("gs_geometry", "geometry", pod, comp, cam.view(), cam.projection(1.0),
                        EYE, 256, 256, 0, False, 1.0, 2, gates)
    assert kernels.LAUNCHES == {**before, "geometry": before["geometry"] + 1}
    kernels.LAUNCHES.update(before)
    [(entry, args)] = lib.calls
    assert entry == "gs_geometry"
    assert list(args[1]) == [n, 2, 1, 0, 0, 2, 0, 0, 0, 0, 0, 3, 0, 0, 0]
    assert args[5:8] == (None, None, None) and args[9] is None
    assert list(args[0])[44:55] == [0.0] * 11


# --- the staged callers ----------------------------------------------------


def _spy(monkeypatch, module):
    """Count the calls `module` makes to `preprocess_fused`."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[0]["color0"].shape[-1])
        return tfused.preprocess_fused(*args, **kwargs)

    monkeypatch.setattr(module, "preprocess_fused", spy)
    return calls


def _words(n, seed, comp=Compressions()):
    return flat_pod_to_words(pack_gaussians(make_random_scene(n, seed=seed, extent=1.0,
                                                              scale_range=(0.02, 0.08)), comp),
                             comp)


def test_staged_viewer_routes_reach_preprocess_fused(monkeypatch):
    """`render_frame` and `MultiModelViewer(fused=False)` preprocess through
    `preprocess_fused` (once a model) and launch no kernel on the CPU."""
    calls = _spy(monkeypatch, viewer_mod)
    comp = Compressions()
    cfg = TileConfig(64, 64, tile=16, max_dup=8)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    kernels.reset_launch_counts()
    img = render_frame(pod_to_tensors(_words(700, 0), "cpu"), comp, cfg, cam.view(),
                       cam.projection(1.0), EYE)
    assert calls == [700] and img.shape == (64, 64, 4)
    v = MultiModelViewer(64, 64, tile=16, max_dup=8, device="cpu", fused=False)
    for i, n in enumerate((500, 300)):
        v.add_model(f"m{i}", make_random_scene(n, seed=i, extent=1.0))
    v.render(cam)
    assert sorted(calls[1:]) == [300, 500]
    assert not any(kernels.LAUNCHES.values())


def test_gloo_sharded_frame_equals_render_frame(monkeypatch, tmp_path):
    """One gloo rank in this process: `render_sharded` preprocesses through
    `preprocess_fused` and equals `render_frame` bit for bit; the merged
    two-model frame equals one sort and composite of both models' entries."""
    calls = _spy(monkeypatch, sharded_mod)
    # The routing stats of this process's sharded render feed the server's
    # /state: kept to this test, so that a later test's state shows none.
    monkeypatch.setattr(sharded_mod, "_LAST", dict(sharded_mod._LAST))
    comp = Compressions()
    cfg = TileConfig(64, 48, tile=16, max_dup=8)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    view, proj = cam.view(), cam.projection(64 / 48)
    words = [_words(768, 0), _words(512, 5)]
    models = np.stack([EYE, EYE])
    models[1, 2, 3] = 0.4
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'group'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh()
        pods = [shard_pod(w, mesh) for w in words]
        kernels.reset_launch_counts()
        img = render_sharded(pods[0], mesh, comp, cfg, view, proj, sh_degree=3)
        merged, overflow = render_frame_sharded_multi(pods, mesh, "splats", comp, cfg, view,
                                                      proj, models, [1, 0], np.zeros(3))
    finally:
        dist.destroy_process_group()
    assert calls == [768, 768, 512] and overflow == 0
    assert not any(kernels.LAUNCHES.values())
    ref = over_background(render_frame(pods[0], comp, cfg, view, proj, EYE, sh_degree=3),
                          np.zeros(3))
    assert torch.equal(img, ref)
    cfg_m = TileConfig(64, 48, tile=16, max_dup=8, model_bits=1)
    parts = [enumerate_entries_from_pre(preprocess(p, comp, view, proj, m, 64, 48), cfg_m,
                                        model_rank=r)
             for p, m, r in zip(pods, models, (1, 0))]
    want = composite_tiles_v2(sort_entries(torch.cat(parts), cfg_m), cfg_m)
    assert torch.equal(merged[:48], over_background(want, np.zeros(3)))


def test_preprocess_fused_ignores_selection_bits_alone():
    """Selection bits without a selection edit or highlight gate nothing, as
    in the plain version (and in the launch, `sel_bits_alone` above)."""
    comp = ALL_COMPRESSIONS[5]
    pod = pod_to_tensors(_words(400, 3, comp), "cpu")
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4))
    args = (pod, comp, cam.view(), cam.projection(1.0), EYE, 64, 64)
    sel = torch.ones(400, dtype=torch.uint8)
    a, b = preprocess_fused(*args, selection_bits=sel), preprocess_fused(*args)
    for f in PreprocessOut.__dataclass_fields__:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_int_param_array_layout():
    """`_int_param_array` for K8: no tiling or key fields; the SH code of
    each compression and the covariance flag."""
    for comp, sh_code in zip(ALL_COMPRESSIONS, (0, 0, 1, 1, 2, 2, 3, 3)):
        arr = tfused._int_param_array(7, comp, 2, 5, sh_degree=1, no_sh0=True, sel_flags=-3)
        assert isinstance(arr, ctypes.Array)
        assert list(arr) == [7, sh_code, int(comp.cov3d.value == "half"), 1, 1, 2, 0, 0, 0, 0,
                             0, 5, -3, 0, 0]
