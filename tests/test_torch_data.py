"""Port data layer against the JAX package: pod words, synthetic scenes,
PLY round trips and the in-place device buffers (CPU, plain torch)."""

import io
import os

import numpy as np
import pytest
import torch

from wgpu_3dgs_viewer_app_tpu.data import compression as jcomp
from wgpu_3dgs_viewer_app_tpu.data import make_random_scene as j_make_random_scene
from wgpu_3dgs_viewer_app_tpu.data import read_ply as j_read_ply
from wgpu_3dgs_viewer_app_tpu.data import write_ply as j_write_ply
from wgpu_3dgs_viewer_app_tpu_torch.convert import pod_from_jax
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
    got = tcomp.flat_pod_to_words(tcomp.pack_gaussians(g, tc), tc)
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k].dtype == got[k].dtype and ref[k].shape == got[k].shape, k
        assert ref[k].tobytes() == got[k].tobytes(), f"{tc}: field {k} differs"


@pytest.mark.parametrize("i", [1, 5, 6], ids=["single-half", "norm8-half", "remove-single"])
def test_pod_from_jax_rows_layout(i):
    """A JAX rows pod (k, R, 128) converts to the port's flat words."""
    jc, tc = _comp_pair(i)
    g = j_make_random_scene(300, seed=2)
    rows = jcomp.pack_gaussians(g, jc, use_native=False)  # (k, R, 128), padded
    pod = pod_from_jax(rows, tc, "cpu", n=g.count)
    ref = tcomp.pod_to_tensors(tcomp.flat_pod_to_words(tcomp.pack_gaussians(g, tc), tc), "cpu")
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
