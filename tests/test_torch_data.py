"""Port data layer against the JAX package: pod words, synthetic scenes,
PLY round trips and exports with baked edits, the JAX buffers' editing
state carried across, and the in-place device buffers (CPU, plain
torch)."""

import io
import os

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu.core import edit as jedit
from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene as j_make_random_scene
from wgpu_3dgs_viewer_app_tpu.data import read_ply as j_read_ply
from wgpu_3dgs_viewer_app_tpu.data import write_ply as j_write_ply
from wgpu_3dgs_viewer_app_tpu.viewer import GaussianBuffers as JBuffers
from wgpu_3dgs_viewer_app_tpu_torch.convert import bits_from_jax, edits_from_jax, pod_from_jax
from wgpu_3dgs_viewer_app_tpu_torch.data import compression as tcomp
from wgpu_3dgs_viewer_app_tpu_torch.data import make_random_scene, read_ply, write_ply
from wgpu_3dgs_viewer_app_tpu_torch.viewer import GaussianBuffers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply")


def _comp_pair(i):
    return jcomp.ALL_COMPRESSIONS[i], tcomp.ALL_COMPRESSIONS[i]


@pytest.mark.parametrize("i", range(8), ids=lambda i: f"{tcomp.ALL_COMPRESSIONS[i].sh.value}-"
                                                      f"{tcomp.ALL_COMPRESSIONS[i].cov3d.value}")
def test_pod_words_byte_equal(i):
    """All 8 compressions: the port's flat word pod is byte-equal to the
    JAX `flat_pod_to_words(pack_gaussians(layout="flat"))` (numpy codec)."""
    jc, tc = _comp_pair(i)
    assert (jc.sh.value, jc.cov3d.value) == (tc.sh.value, tc.cov3d.value)
    assert jc.bytes_per_splat() == tc.bytes_per_splat()
    g = j_make_random_scene(3000, seed=11)
    ref = jcomp.flat_pod_to_words(jcomp.pack_gaussians(g, jc, use_native=False, layout="flat"), jc)
    got = tcomp.flat_pod_to_words(tcomp.pack_gaussians(g, tc, use_native=False), tc)
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape, k
        assert ref[k].tobytes() == got[k].tobytes(), f"{tc}: {_word_diff(k, ref[k], got[k])}"


def _word_diff(name, a, b) -> str:
    """What differs between two equal-shaped pod fields: the field, how many
    of its words, and (f32 fields) by how many ulps at most and where."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    ne = a != b
    if a.dtype == np.float32:
        ne |= np.isnan(a) != np.isnan(b)
        ia, ib = (x.view(np.int32).astype(np.int64) for x in (a, b))
        # Ordered-integer form: adjacent floats differ by 1, across zero too.
        ia, ib = (np.where(i < 0, -(i & 0x7FFFFFFF), i) for i in (ia, ib))
        ulps = np.abs(ia - ib)
        worst = np.unravel_index(int(ulps.argmax()), ulps.shape)
        detail = (f", at most {int(ulps.max())} ulps (at {tuple(int(i) for i in worst)}: "
                  f"reference {a[worst]!r}, port {b[worst]!r})")
    else:
        detail = ""
    bad = np.argwhere(ne)
    return (f"field {name} ({a.dtype}, shape {a.shape}) differs in {len(bad)} of {a.size} words"
            f"{detail}; first at {bad[:5].tolist()}")


@pytest.mark.parametrize("i", [1, 5, 6], ids=["single-half", "norm8-half", "remove-single"])
def test_pod_from_jax_rows_layout(i):
    """A JAX rows pod (k, R, 128) converts to the port's flat words."""
    jc, tc = _comp_pair(i)
    g = j_make_random_scene(300, seed=2)
    rows = jcomp.pack_gaussians(g, jc, use_native=False)  # (k, R, 128), padded
    pod = pod_from_jax(rows, tc, "cpu", n=g.count)
    ref = tcomp.pod_to_tensors(
        tcomp.flat_pod_to_words(tcomp.pack_gaussians(g, tc, use_native=False), tc), "cpu")
    assert set(pod) == set(ref)
    for k in ref:
        assert torch.equal(pod[k], ref[k]), k


@pytest.mark.parametrize("n,seed,kw", [(1000, 0, {}),
                                       (5000, 3, {"extent": 2.0, "scale_range": (0.004, 0.02)})])
def test_make_random_scene_identical(n, seed, kw):
    a, b = j_make_random_scene(n, seed=seed, **kw), make_random_scene(n, seed=seed, **kw)
    for name in ("pos", "normal", "sh0", "sh_rest", "opacity", "scale", "rot"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_ply_roundtrip_fixture_prefix():
    """Fixture prefix: the port reads what the JAX reader reads, writes the
    same bytes, and reads its own output back unchanged."""
    ga, gb = j_read_ply(FIXTURE), read_ply(FIXTURE)
    assert ga.count == gb.count
    keep = np.arange(ga.count) < 5000
    ga, gb = ga.select(keep), gb.select(keep)
    fa, fb = io.BytesIO(), io.BytesIO()
    j_write_ply(fa, ga)
    assert write_ply(fb, gb) == 5000
    assert fa.getvalue() == fb.getvalue()
    back = read_ply(io.BytesIO(fb.getvalue()))
    for name in ("pos", "normal", "sh0", "sh_rest", "opacity", "scale", "rot"):
        assert np.array_equal(getattr(back, name), getattr(ga, name)), name


def test_buffers_update_range_in_place():
    """Streaming two chunks writes the same pod as one upload, in place."""
    comp = tcomp.Compressions()
    g = make_random_scene(700, seed=4)
    whole = GaussianBuffers(1000, comp, "cpu")
    whole.upload_all(g)
    parts = GaussianBuffers(1000, comp, "cpu")
    ptrs = {k: v.data_ptr() for k, v in parts.pod.items()}
    parts.update_range(0, g.slice(0, 300))
    parts.update_range(300, g.slice(300, 700))
    assert len(parts) == 700
    for k, v in parts.pod.items():
        assert v.data_ptr() == ptrs[k], f"{k} was reallocated"
        assert torch.equal(v, whole.pod[k]), k
    assert int(parts.pod["color0"][700:].abs().sum()) == 0  # empty slots: alpha 0
    with pytest.raises(ValueError):
        parts.update_range(900, g.slice(0, 200))


def _edits(n, seed=6):
    """A per-splat edit SoA with every flag combination (numpy seed)."""
    rng = np.random.default_rng(seed)
    flags, rgb, params = jedit.make_edit_soa(n)
    flags[:] = rng.integers(0, 8, n)
    rgb[:] = rng.uniform([-1.0, 0.0, 0.0], [1.0, 1.5, 1.5], (n, 3))
    params[:] = rng.uniform([-0.4, -0.8, 0.4, 0.2], [0.4, 0.8, 2.5, 1.0], (n, 4))
    return flags, rgb, params


@pytest.mark.parametrize("with_mask", [False, True], ids=["edits", "edits+mask"])
def test_write_ply_with_edits_bytes_equal(with_mask):
    """Baked exports: the port writes the JAX package's bytes (hidden splats
    dropped, unedited splats unchanged)."""
    g = read_ply(FIXTURE)
    g = g.select(np.arange(g.count) < 3000)
    edits = _edits(g.count)
    mask = np.random.default_rng(1).random(g.count) > 0.2 if with_mask else None
    fa, fb = io.BytesIO(), io.BytesIO()
    na = j_write_ply(fa, g, edits=edits, mask=mask)
    nb = write_ply(fb, g, edits=edits, mask=mask)
    assert na == nb < g.count
    assert fa.getvalue() == fb.getvalue()


def test_edits_and_bits_from_jax():
    """The JAX buffers' padded edit SoA, selection and mask -> the port's
    tensors at the port's capacity, then into the port's buffers."""
    n = 300
    jb = JBuffers(n, jcomp.ALL_COMPRESSIONS[5])
    assert jb.capacity == 384  # padded to 128
    flags, rgb, params = _edits(jb.capacity)
    jb.set_edits(flags, rgb, params)
    jb.set_selection(np.arange(n) % 3 == 0)
    jb.set_mask(np.arange(n) % 5 != 0)
    ef, er, ep = edits_from_jax(np.asarray(jb.edit_flags), np.asarray(jb.edit_rgb),
                                np.asarray(jb.edit_params), n)
    assert ef.dtype == torch.int32 and ef.shape == (n,)
    assert er.shape == (n, 3) and ep.shape == (n, 4)
    assert np.array_equal(ef.numpy().view(np.uint32), flags[:n])
    assert np.array_equal(er.numpy(), rgb[:n]) and np.array_equal(ep.numpy(), params[:n])
    sel = bits_from_jax(np.asarray(jb.selection), n)
    mask = bits_from_jax(np.asarray(jb.mask), n)
    assert sel.dtype == mask.dtype == torch.uint8 and sel.shape == mask.shape == (n,)
    tb = GaussianBuffers(n, tcomp.ALL_COMPRESSIONS[5], "cpu")
    tb.loaded = jb.loaded = n
    tb.set_edits(ef, er, ep)
    tb.set_selection(sel)
    tb.set_mask(mask)
    for a, b in zip(jb.download_edits(), tb.download_edits()):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(jb.download_selection(), tb.download_selection())
    assert np.array_equal(jb.download_mask(), tb.download_mask())
    with pytest.raises(ValueError, match="capacity"):
        bits_from_jax(np.asarray(jb.mask), jb.capacity + 1)
