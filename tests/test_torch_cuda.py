"""Card tests: each hand-written CUDA kernel against its plain torch version
on the same CUDA tensors (the front-end K1 ungated and gated, the entry
sort K2 row for row, the v2 compositor K3 in every mode of its wrapper
(Horner and quadratic-basis exponent, flat, both `transposed`), the query
geometry K4, the preprocess K8 bit for bit (ungated and gated) and the
staged route on it, the enumerate-and-pack kernel K5, K1 with a model rank; K1
and K5 also on fewer splats than one block, one over a block boundary and
into a row slice of a larger tensor), the
wrappers' input checks, and the whole slice on the card against the CPU,
the merged multi-model frame included; the v1 chain's sort (K2 at the v1
key layout) and compositor K6; K3 and K6 at tiles over 32 px (one block up
to 64, a thread block cluster up to 256, 32-px parts in two launches
above, also on a tile larger than the image); the app session's masked
frame; the JPEG encoder's bytes on the card against the CPU's, the web
viewer's `frame_jpeg` over a session on the card, the sharded renderer
over NCCL at world size 1 against the single-device frame, and the
overlay kernel K9 bit for bit its plain versions (segments, tint, ring, in
every combination) and in the session's frame. At the end, end to end at
small sizes, the paths no benchmark cell runs; then K1-K6 and K8 against
their plain versions at the shapes of BASELINE configs 1-3 (`scripts/card.py`).

Every test here needs an NVIDIA GPU and nvcc and skips without them. The
file imports neither JAX nor the JAX package, so it also runs on a machine
without JAX (from the repo root):

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import io
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from test_golden import assert_golden_close
from wgpu_3dgs_viewer_app_tpu_torch.app import (Action, ExportChoice, GaussianSplattingSession,
                                                MeasurementHitPair, SceneCommand,
                                                SceneCommandKind, SelectionEdit, SelectionMethod,
                                                ViewerServer, export_models, make_handler)
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl
from wgpu_3dgs_viewer_app_tpu_torch.core import edit as tedit
from wgpu_3dgs_viewer_app_tpu_torch.core.lines import (rasterize_lines, rasterize_lines_plain,
                                                       segment_table)
from wgpu_3dgs_viewer_app_tpu_torch.data import (
    ALL_COMPRESSIONS, Compressions, Cov3dCompression, ShCompression, flat_pod_to_words,
    make_random_scene, pack_gaussians, pod_to_tensors, read_ply, read_ply_header, write_ply)
from wgpu_3dgs_viewer_app_tpu_torch.data.compression import cov3d_components
from wgpu_3dgs_viewer_app_tpu_torch.app.measurement import measurement_lines
from wgpu_3dgs_viewer_app_tpu_torch.mask import MaskShape, MaskShapeKind
from wgpu_3dgs_viewer_app_tpu_torch.mask.gizmo import gizmo_lines
from wgpu_3dgs_viewer_app_tpu_torch.core import ModelTransform
from wgpu_3dgs_viewer_app_tpu_torch.ops import (
    SENTINEL, PreprocessOut, TileConfig, build_entry_planes, build_sorted_entries,
    build_sorted_entries_fused, build_tile_lists, composite_tiles, composite_tiles_plain,
    composite_tiles_plain_v2, composite_tiles_v2, enumerate_entries_from_pre,
    enumerate_entries_from_pre_plain, enumerate_entries_fused, enumerate_entries_plain, kernels,
    over_background, overlay_cuda, preprocess, preprocess_fused, preprocess_geometry_fused,
    preprocess_geometry_plain, sort_entries, sort_entries_plain)
from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import tile_list_entries
from wgpu_3dgs_viewer_app_tpu_torch.ops.composite import composite_budget, composite_launches
from wgpu_3dgs_viewer_app_tpu_torch.query import (
    MeasurementHitMethod, QuerySelectionOp, QueryToolset, apply_query_pod, combine_selection,
    query_hit, sample_texture_at_centers, select_rect)
from wgpu_3dgs_viewer_app_tpu_torch.query.overlay import (overlay_cursor_ring_plain,
                                                          overlay_texture_plain)
from wgpu_3dgs_viewer_app_tpu_torch.testing import (compare_entries, compare_preprocess,
                                                    compare_preprocess_bits, compare_sorted)
from wgpu_3dgs_viewer_app_tpu_torch.utils import jpeg, trace
from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer, Viewer, render_frame

sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "scripts"))
import card  # noqa: E402  (scripts/card.py: the BASELINE scenes, shared with the card scripts)

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# K3 and K6 end where their plain versions end: they differ by rounding.
K67_TOL = 1e-4
EYE = np.eye(4, dtype=np.float32)


def _only(**counts) -> dict:
    """The launch counts of a run that launched these kernels only."""
    return {**dict.fromkeys(kernels.LAUNCHES, 0), **counts}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pod(comp, n, dev, seed=0, extent=2.0, scale_range=(0.004, 0.05)):
    g = make_random_scene(n, seed=seed, extent=extent, scale_range=scale_range)
    return pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), dev)


def _camera(w, h, pos=(0.3, 0.2, -6.0)):
    cam = CameraOrbitControl(target=(0, 0, 0), pos=pos)
    return cam.view(), cam.projection(w / h)


def _check_into_slice(write, want):
    """`write(out)` into rows 5 .. 5 + len(want) of a larger tensor (80 bytes
    in: aligned to 16 bytes, not to 128) gives `want` there and leaves the
    rows before and after as they were."""
    fill, e = 0x5A5A5A5A, want.shape[0]
    big = torch.full((e + 12, 4), fill, dtype=torch.int32, device=want.device)
    part = big[5:5 + e]
    assert write(part).data_ptr() == part.data_ptr()
    assert torch.equal(part, want)
    assert bool((big[:5] == fill).all()) and bool((big[5 + e:] == fill).all())


@pytest.mark.parametrize("ci", range(8), ids=lambda i: f"{ALL_COMPRESSIONS[i].sh.value}-"
                                                      f"{ALL_COMPRESSIONS[i].cov3d.value}")
@pytest.mark.parametrize("deg,mode,d,n", [
    (3, 0, 4, 20000), (1, 1, 8, 20000), (0, 2, 4, 20000), (2, 0, 16, 20000),
    (3, 0, 4, 100), (3, 0, 8, 257), (3, 1, 16, 129), (3, 0, 20, 1000)])
def test_frontend_kernel_matches_plain(dev, ci, deg, mode, d, n):
    """K1 vs plain preprocess + enumerate: all compressions, SH 0-3, the
    three display modes, several max_dup (20: two rounds of the block's
    stage), fewer splats than one block and one over a block boundary;
    written into a row slice of a larger tensor whose other rows stay."""
    comp = ALL_COMPRESSIONS[ci]
    pod = _pod(comp, n, dev, seed=ci)
    cfg = TileConfig(1920, 1080, tile=32, max_dup=d)
    view, proj = _camera(1920, 1080)
    before = kernels.LAUNCHES["fused"]
    got = enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, sh_degree=deg,
                                  display_mode=mode)
    assert kernels.LAUNCHES["fused"] == before + 1
    ref = enumerate_entries_plain(pod, comp, cfg, view, proj, EYE, sh_degree=deg,
                                  display_mode=mode)
    stats = compare_entries(got, ref, cfg)
    assert stats["live_a"] > n // 20, stats
    _check_into_slice(lambda out: enumerate_entries_fused(pod, comp, cfg, view, proj, EYE,
                                                          sh_degree=deg, display_mode=mode,
                                                          out=out), got)



GATE_PATTERNS = {"mask": ("mask",), "edit": ("edit",), "sel_edit": ("sel_edit",),
                 "highlight": ("highlight",), "sel_edit+highlight": ("sel_edit", "highlight"),
                 "all": ("mask", "edit", "sel_edit", "highlight")}
GATE_KEYS = {"mask": ("mask_bits",), "edit": ("edit",),
             "sel_edit": ("selection_bits", "selection_edit"),
             "highlight": ("selection_bits", "highlight_rgba")}


def _gates(n, dev, which, seed=3):
    """The gates `which` of `card.gates`, in the dtypes the kernels read."""
    keys = {k for w in which for k in GATE_KEYS[w]}
    return {k: v for k, v in card.gates(n, dev, seed).items() if k in keys}


@pytest.mark.parametrize("pattern", list(GATE_PATTERNS))
@pytest.mark.parametrize("n,d", [(20000, 4), (100, 8), (257, 16)])
def test_gated_frontend_kernel_matches_plain(dev, pattern, n, d):
    """Gated K1 vs the gated plain preprocess + enumerate, each gate alone
    and together (default compression, SH 3, 1080p, tile 32), at max_dup 4,
    8 and 16, fewer splats than one block and one over a block boundary;
    also into a row slice of a larger tensor."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, n, dev, seed=7)
    cfg = TileConfig(1920, 1080, tile=32, max_dup=d)
    view, proj = _camera(1920, 1080)
    gates = _gates(n, dev, GATE_PATTERNS[pattern])
    before = kernels.LAUNCHES["fused"]
    got = enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, **gates)
    assert kernels.LAUNCHES["fused"] == before + 1
    ref = enumerate_entries_plain(pod, comp, cfg, view, proj, EYE, **gates)
    stats = compare_entries(got, ref, cfg)
    assert stats["live_a"] > n // 20, stats
    ungated = enumerate_entries_fused(pod, comp, cfg, view, proj, EYE)
    assert not torch.equal(got, ungated)
    _check_into_slice(lambda out: enumerate_entries_fused(pod, comp, cfg, view, proj, EYE,
                                                          out=out, **gates), got)


@pytest.mark.parametrize("ci", range(8), ids=lambda i: f"{ALL_COMPRESSIONS[i].sh.value}-"
                                                      f"{ALL_COMPRESSIONS[i].cov3d.value}")
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_geometry_kernel_matches_plain(dev, ci, mode, gated):
    """K4 vs the plain preprocess at SH degree 0 (`compare_preprocess`):
    all compressions, the three display modes, with and without the mask
    and per-splat edit gates."""
    comp = ALL_COMPRESSIONS[ci]
    pod = _pod(comp, 20000, dev, seed=ci)
    view, proj = _camera(1920, 1080)
    gates = _gates(20000, dev, ("mask", "edit")) if gated else {}
    before = kernels.LAUNCHES["geometry"]
    got = preprocess_geometry_fused(pod, comp, view, proj, EYE, 1920, 1080, display_mode=mode,
                                    **gates)
    assert kernels.LAUNCHES["geometry"] == before + 1
    ref = preprocess_geometry_plain(pod, comp, view, proj, EYE, 1920, 1080, display_mode=mode,
                                    **gates)
    stats = compare_preprocess(got, ref)
    assert stats["valid"] > 1000, stats


@pytest.mark.parametrize("ci", range(8), ids=lambda i: f"{ALL_COMPRESSIONS[i].sh.value}-"
                                                      f"{ALL_COMPRESSIONS[i].cov3d.value}")
@pytest.mark.parametrize("deg,mode,no_sh0,n", [
    (3, 0, False, 20000), (2, 1, False, 20000), (1, 2, False, 20000), (0, 0, False, 20000),
    (3, 1, True, 20000), (3, 0, False, 100), (2, 2, False, 257)])
def test_preprocess_kernel_matches_plain(dev, ci, deg, mode, no_sh0, n):
    """K8 vs the plain preprocess bit for bit, every field and `valid` of
    every splat: all compressions, SH 0-3, the three display modes,
    `no_sh0`, fewer splats than one block and one over a block boundary."""
    comp = ALL_COMPRESSIONS[ci]
    pod = _pod(comp, n, dev, seed=ci)
    view, proj = _camera(1920, 1080)
    kw = dict(sh_degree=deg, no_sh0=no_sh0, display_mode=mode)
    before = kernels.LAUNCHES["preprocess"]
    got = preprocess_fused(pod, comp, view, proj, EYE, 1920, 1080, **kw)
    assert kernels.LAUNCHES["preprocess"] == before + 1
    stats = compare_preprocess_bits(got, preprocess(pod, comp, view, proj, EYE, 1920, 1080, **kw))
    assert stats["valid"] > n // 20, stats


@pytest.mark.parametrize("pattern", list(GATE_PATTERNS))
@pytest.mark.parametrize("ci,deg,mode", [(5, 3, 0), (0, 2, 1), (3, 1, 2), (6, 0, 0)])
def test_gated_preprocess_kernel_matches_plain(dev, pattern, ci, deg, mode):
    """Gated K8 vs the gated plain preprocess bit for bit, each gate alone
    and together, in four compressions, SH degrees and display modes; the
    gates change the output."""
    comp = ALL_COMPRESSIONS[ci]
    pod = _pod(comp, 20000, dev, seed=11)
    view, proj = _camera(1920, 1080)
    gates = _gates(20000, dev, GATE_PATTERNS[pattern])
    args = (pod, comp, view, proj, EYE, 1920, 1080)
    kw = dict(sh_degree=deg, display_mode=mode)
    got = preprocess_fused(*args, **kw, **gates)
    stats = compare_preprocess_bits(got, preprocess(*args, **kw, **gates))
    assert stats["valid"] > 1000, stats
    with pytest.raises(AssertionError):
        compare_preprocess_bits(got, preprocess_fused(*args, **kw))


def test_staged_route_runs_preprocess_kernel(dev):
    """The staged route on K8: K5 fed K8's planes writes the entries K5 fed
    the plain planes writes, slot for slot; `render_frame` launches K8, K5,
    K2 and K3 once each and equals the same pipeline on the plain
    preprocess bit for bit; the viewer's staged route launches K8 once a
    model."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 20000, dev, seed=2)
    cfg = TileConfig(512, 384, tile=16, max_dup=8)
    view, proj = _camera(512, 384)
    gates = _gates(20000, dev, ("mask", "edit", "sel_edit", "highlight"))
    pre_k = preprocess_fused(pod, comp, view, proj, EYE, 512, 384, **gates)
    pre_p = preprocess(pod, comp, view, proj, EYE, 512, 384, **gates)
    assert torch.equal(enumerate_entries_from_pre(pre_k, cfg),
                       enumerate_entries_from_pre(pre_p, cfg))
    kernels.reset_launch_counts()
    img = render_frame(pod, comp, cfg, view, proj, EYE, **gates)
    assert kernels.LAUNCHES == _only(preprocess=1, enum_pack=1, sort=1, composite=1)
    assert torch.equal(img, composite_tiles_v2(build_sorted_entries(pre_p, cfg), cfg))
    v = MultiModelViewer(512, 384, tile=16, max_dup=8, device=dev, fused=False)
    for i in range(2):
        v.add_model(f"m{i}", make_random_scene(3000, seed=i, extent=1.2))
    kernels.reset_launch_counts()
    v.render(CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4.5)))
    assert kernels.LAUNCHES == _only(preprocess=2, enum_pack=2, sort=1, composite=1)


def test_gate_wrappers_reject_bad_inputs(dev):
    """Gate tensors of the wrong dtype, shape or device are refused by K1's,
    K4's and K8's wrappers, before any launch; so is an SH degree over 3."""
    comp = ALL_COMPRESSIONS[5]
    n = 1000
    pod = _pod(comp, n, dev)
    cfg = TileConfig(256, 256, tile=32, max_dup=4)
    view, proj = _camera(256, 256)
    good = _gates(n, dev, ("mask", "edit", "sel_edit", "highlight"))
    flags, rgb, params = good["edit"]
    bad = [
        ({"mask_bits": good["mask_bits"].bool()}, "mask_bits"),
        ({"mask_bits": good["mask_bits"][:-1]}, "mask_bits"),
        ({"mask_bits": good["mask_bits"].cpu()}, "mask_bits"),
        ({"edit": (flags.long(), rgb, params)}, "edit flags"),
        ({"edit": (flags, rgb[:, :2].contiguous(), params)}, "edit rgb"),
        ({"edit": (flags, rgb, params.cpu())}, "edit params"),
        ({"selection_bits": good["selection_bits"].float(),
          "highlight_rgba": good["highlight_rgba"]}, "selection_bits"),
    ]
    before = dict(kernels.LAUNCHES)
    for kw, name in bad:
        with pytest.raises(ValueError, match=name):
            enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, **kw)
        with pytest.raises(ValueError, match=name):
            preprocess_fused(pod, comp, view, proj, EYE, 256, 256, **kw)
        if "selection_bits" not in kw:
            with pytest.raises(ValueError, match=name):
                preprocess_geometry_fused(pod, comp, view, proj, EYE, 256, 256, **kw)
    with pytest.raises(ValueError, match="sh_degree 4"):
        preprocess_fused(pod, comp, view, proj, EYE, 256, 256, sh_degree=4)
    assert kernels.LAUNCHES == before


def _entries(e, frac, cfg, seed, n_keys=0):
    """(e, 4) entries in real tiles, `frac` of the slots dead; with `n_keys`,
    the live keys take only that many distinct values (heavy ties)."""
    rng = np.random.default_rng(seed)
    tiles = rng.integers(0, cfg.n_tiles, e, dtype=np.uint64)
    low = rng.integers(0, 1 << 10, e, dtype=np.uint64)
    keys = ((tiles << np.uint64(cfg._tile_shift)) | low).astype(np.uint32)
    if n_keys:
        keys = rng.choice(np.unique(keys)[:n_keys], e)
    keys[rng.random(e) < frac] = SENTINEL
    pay = rng.integers(0, 2**32, (e, 3), dtype=np.uint64).astype(np.uint32)
    return np.ascontiguousarray(np.concatenate([keys[:, None], pay], axis=1)).view(np.int32)


@pytest.mark.parametrize("e,frac,n_keys", [
    (0, 0.0, 0), (777, 1.0, 0), (1, 0.0, 0), (2049, 0.5, 0), (3073, 0.0, 0), (65536, 0.44, 0),
    (1 << 20, 0.0, 0), (3_000_001, 0.44, 0), (1 << 20, 0.3, 16)])
def test_sort_kernel_matches_plain(dev, e, frac, n_keys):
    """K2 vs torch.sort(stable=True) + gather, row for row: keys, payloads
    and tile ranges equal, ties in slot order. 1080p at 16-px tiles puts
    bit 31 in many keys; the last case puts 1M entries on 16 keys."""
    cfg = TileConfig(1920, 1080, tile=16, max_dup=4)
    ent = torch.from_numpy(_entries(e, frac, cfg, seed=e, n_keys=n_keys)).to(dev)
    before = kernels.LAUNCHES["sort"]
    got = sort_entries(ent, cfg)
    assert kernels.LAUNCHES["sort"] == before + 1
    compare_sorted(got, sort_entries_plain(ent, cfg), stable=True)
    # The status words and tickets are reset per call: a second call agrees.
    assert torch.equal(sort_entries(ent, cfg).live(), got.live())


@pytest.mark.parametrize("tile,mode,transposed,mxu", [
    (32, 0, True, False), (16, 0, True, False), (32, 1, True, False), (32, 2, True, False),
    (16, 0, False, False), (16, 0, False, True), (32, 0, False, True), (32, 2, False, False),
    (16, 1, True, True), (10, 0, True, True)]
    + [(tile, mode, True, mxu) for tile in (40, 64, 128, 256, 257, 320)
       for mode, mxu in ((0, False), (0, True), (1, False))]
    + [(tile, 2, True, False) for tile in (40, 64, 128)])
def test_composite_kernel_matches_plain(dev, tile, mode, transposed, mxu):
    """K3 vs its plain version within rounding in every mode of the wrapper
    (Horner or quadratic-basis exponent, splat, ellipse or point, both
    `transposed`): the one kernel, in one launch up to 16 px and from 65 to
    256, in two from 23 to 32 (a budgeted first pass, then the tiles that
    outlast it across a cluster) and over 256; `transposed` selects
    nothing. Tile 10 leaves the last 4-pixel group of each row half outside
    the tile. Over 32 px: tiles 40 and 64 run pass 1 in one block of up to
    1024 threads a tile, 128 a cluster of 4 row bands and 256 one of 16 (the
    most a cluster holds), which stop together at the whole-tile exit test;
    257 and 320 run 32-px parts in two launches, which keep that test (512,
    below, on an image smaller than the tile: at 1920x1080 the entries'
    tile-relative means, clamped to +-128 px, leave most of a 512-px tile
    empty, and from 256 px so few of point mode's small splats land that
    its frame covers under 5%: point mode runs to 128 here, and over 256
    below)."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 50000, dev)
    cfg = TileConfig(1920, 1080, tile=tile, max_dup=4)
    view, proj = _camera(1920, 1080)
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE, display_mode=mode)
    flat = mode != 0
    before = dict(kernels.LAUNCHES)
    got = composite_tiles_v2(se, cfg, flat_mode=flat, transposed=transposed, mxu=mxu)
    launches = 2 if 22 < tile <= 32 or tile > 256 else 1
    assert composite_launches(tile) == launches
    assert kernels.LAUNCHES == {**before, "composite": before["composite"] + launches}
    ref = composite_tiles_plain_v2(se, cfg, flat_mode=flat, mxu=mxu)
    assert float(got[..., 3].mean()) > 0.05
    assert float((got - ref).abs().max()) <= K67_TOL
    assert torch.equal(got, composite_tiles_v2(se, cfg, flat_mode=flat,
                                               transposed=not transposed, mxu=mxu))


@pytest.mark.parametrize("tile", [257, 320, 512])
@pytest.mark.parametrize("mode,mxu", [(0, False), (0, True), (1, False), (2, False)])
def test_composite_kernel_tile_over_image_matches_plain(dev, tile, mode, mxu):
    """K3 at tiles over 256 px larger than the 256x192 image (one tile, whose
    pixels outside the image hold up its exit) vs its plain version."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 3000, dev, seed=4, extent=1.0, scale_range=(0.01, 0.06))
    cfg = TileConfig(256, 192, tile=tile, max_dup=4)
    view, proj = _camera(256, 192, pos=(0.2, 0.3, -3.5))
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE, display_mode=mode)
    got = composite_tiles_v2(se, cfg, flat_mode=mode != 0, mxu=mxu)
    ref = composite_tiles_plain_v2(se, cfg, flat_mode=mode != 0, mxu=mxu)
    assert float(got[..., 3].mean()) > 0.05
    assert float((got - ref).abs().max()) <= K67_TOL


def _faint_dense_pod(dev, comp):
    """3000 large splats at opacity 0.15-0.35 that cover the whole view: the
    tiles close before their last chunk, with T at the exit close enough to
    1/255 that a walk past the exit moves pixels by ~1e-3."""
    g = make_random_scene(3000, seed=5, extent=2.0, scale_range=(0.4, 0.8))
    op = np.random.default_rng(1).uniform(0.15, 0.35, g.count).astype(np.float32)
    g = dataclasses.replace(g, opacity=np.log(op / (1.0 - op)).astype(np.float32))
    return pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), dev)


@pytest.mark.parametrize("mode,mxu", [(0, False), (0, True), (1, False)])
def test_composite_kernel_tile_closes_early_matches_plain(dev, mode, mxu):
    """K3 at tile 260 (32-px parts in two launches) where the tiles close
    before their last chunk (the plain version's rows read): pass 2 must
    stop at the tile's exit chunk."""
    comp = ALL_COMPRESSIONS[5]
    cfg = TileConfig(520, 260, tile=260, max_dup=4)
    view, proj = _camera(520, 260, pos=(0.2, 0.3, -3.5))
    se = build_sorted_entries_fused(_faint_dense_pod(dev, comp), comp, cfg, view, proj, EYE,
                                    display_mode=mode)
    before = dict(kernels.LAUNCHES)
    got = composite_tiles_v2(se, cfg, flat_mode=mode != 0, mxu=mxu)
    assert kernels.LAUNCHES == {**before, "composite": before["composite"] + 2}
    work = {}
    ref = composite_tiles_plain_v2(se, cfg, flat_mode=mode != 0, stats=work, mxu=mxu)
    starts = se.tile_starts.long()
    ends = starts + se.tile_counts.long()
    chunks = int(torch.where(ends > starts, (ends + 127) // 128 - starts // 128, 0).sum())
    assert work["rows"] < chunks
    assert float(got[..., 3].min()) > 0.9
    assert float((got - ref).abs().max()) <= K67_TOL


def _sparse_long_pod(dev, comp):
    """120,000 small faint splats (opacity 0.02-0.08): long runs of many
    chunks a tile whose pixels stay open, so that the tiles walk on past
    the chunk budget, as the sparse tiles of a capture do."""
    g = make_random_scene(120_000, seed=6, extent=1.5, scale_range=(0.003, 0.01))
    op = np.random.default_rng(2).uniform(0.02, 0.08, g.count).astype(np.float32)
    g = dataclasses.replace(g, opacity=np.log(op / (1.0 - op)).astype(np.float32))
    return pod_to_tensors(flat_pod_to_words(pack_gaussians(g, comp), comp), dev)


@pytest.mark.parametrize("mode,mxu", [(0, False), (0, True), (1, False), (2, False)])
@pytest.mark.parametrize("tile", [24, 28, 32])
@pytest.mark.parametrize("case", ["outlast", "none"])
def test_composite_kernel_budget_split_matches_plain(dev, case, tile, mode, mxu):
    """K3's two passes at tiles of 23 to 32 px (pass 2 at one pixel a thread,
    a warp on 8 x 4 pixels: at 24 px 2 bands of 288 threads, at 28 3 of
    384, at 32 4 of 256) against the plain version, on a 330x250 image
    whose edge tiles hold pixels past it: with
    long sparse runs, where tiles outlast the chunk budget, and on a small
    scene where none does (pass 2 takes an empty list). Inside
    `trace.collect()` the device counter reads the tiles and chunks left
    that the plain version's chunk walks hand on: the tiles that walk past
    the budget; outside, nothing is counted. A second call is the first's
    bit for bit, whatever order the tiles took the list in."""
    comp = ALL_COMPRESSIONS[5]
    w, h = 330, 250
    pod = _sparse_long_pod(dev, comp) if case == "outlast" else _pod(comp, 1500, dev, seed=7)
    cfg = TileConfig(w, h, tile=tile, max_dup=4)
    view, proj = _camera(w, h, pos=(0.2, 0.3, -3.5))
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE, display_mode=mode)
    flat = mode != 0
    work = {}
    ref = composite_tiles_plain_v2(se, cfg, flat_mode=flat, stats=work, mxu=mxu)
    budget = composite_budget()
    starts = se.tile_starts.long().cpu()
    ends = starts + se.tile_counts.long().cpu()
    n_chunks = torch.where(ends > starts, (ends + 127) // 128 - starts // 128, 0)
    out = work["walked"] > budget
    if case == "outlast":
        assert int(out.sum()) >= 4 and int(work["walked"].max()) >= 2 * budget
    else:
        assert not bool(out.any())
    before = dict(kernels.LAUNCHES)
    trace.reset()
    with trace.collect():
        got = composite_tiles_v2(se, cfg, flat_mode=flat, mxu=mxu)
    assert trace.k3_resumed() == (int(out.sum()), int((n_chunks[out] - budget).sum()))
    trace.reset()
    assert kernels.LAUNCHES == {**before, "composite": before["composite"] + 2}
    assert float(got[..., 3].mean()) > 0.05
    assert float((got - ref).abs().max()) <= K67_TOL
    assert torch.equal(got, composite_tiles_v2(se, cfg, flat_mode=flat, mxu=mxu))
    assert trace.k3_resumed() is None


def test_wrappers_reject_bad_inputs(dev):
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 1000, dev)
    cfg = TileConfig(256, 256, tile=32, max_dup=4)
    view, proj = _camera(256, 256)
    bad = dict(pod, pos=pod["pos"].double())
    with pytest.raises(ValueError, match="pos"):
        enumerate_entries_fused(bad, comp, cfg, view, proj, EYE)
    with pytest.raises(ValueError, match="entries"):
        sort_entries(torch.zeros((10, 3), dtype=torch.int32, device=dev), cfg)
    se = build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE)
    with pytest.raises(ValueError, match="tile 0"):
        composite_tiles_v2(se, TileConfig(256, 256, tile=0, max_dup=4))


def test_viewer_on_card_matches_cpu(dev):
    """The golden scene through the kernels on the card vs the plain path
    on the CPU."""
    g = read_ply(os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply"))
    g = g.select(np.arange(g.count) < 20_000)
    center = g.center()
    dist = float(np.abs(g.pos - center).max()) * 2.0
    yaw = math.radians(30.0)
    cam = CameraOrbitControl(target=center, pos=center + dist * np.array(
        [math.sin(yaw), 0.3, math.cos(yaw)], np.float32))
    kernels.reset_launch_counts()
    got = Viewer(g, 256, 256, max_dup=16, device=dev).render(cam)
    assert kernels.LAUNCHES == _only(fused=1, sort=1, composite=composite_launches(32))
    ref = Viewer(g, 256, 256, max_dup=16, device="cpu").render(cam)
    # CPU and card transcendentals may move a depth key by one step, which
    # can reorder near-ties: hold the two to the golden gate.
    assert_golden_close(_u8(got.cpu()), _u8(ref))


def _u8(img):
    return np.clip(img.numpy() * 255.0, 0, 255).astype(np.uint8).astype(np.int16)


def test_session_masked_frame_on_card_matches_cpu(dev):
    """The app session on the golden scene (streamed in from PLY bytes):
    three mask shapes and `(0 | 1) - 2` sent as EvaluateMask, one `update()`
    frame with the gizmos on the card (gated K1, K2, K3 and K9 once each) against
    the same session on the CPU, the mask bits equal (every containment
    step is one rounded f32 operation on both devices), and a hit query on
    the card (K4) against the CPU one."""
    g = read_ply(os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply"))
    g = g.select(np.arange(g.count) < 20_000)
    buf = io.BytesIO()
    write_ply(buf, g)
    center = g.center()
    ext = float(np.abs(g.pos - center).max())
    dist = ext * 2.0
    yaw = math.radians(30.0)
    pos = center + dist * np.array([math.sin(yaw), 0.3, math.cos(yaw)], np.float32)
    out = []
    for device in (dev, "cpu"):
        s = GaussianSplattingSession(width=256, height=256, device=device, max_dup=16)
        s.camera.control.target, s.camera.control.pos = center, pos
        s.open_model("golden.ply", io.BytesIO(buf.getvalue()))
        while s.loader is not None:
            s._drain_loader()
        for kind, off, scale in ((MaskShapeKind.BOX, 0.0, 1.0), (MaskShapeKind.ELLIPSOID, 0.3, 0.8),
                                 (MaskShapeKind.BOX, -0.3, 0.4)):
            s.mask.add_shape(MaskShape(kind=kind, pos=center + np.float32(off * ext),
                                       scale=np.full(3, scale * ext, np.float32)))
        s.mask.op_code = "(0 | 1) - 2"
        s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=s.mask.parse_op()))
        kernels.reset_launch_counts()
        img = s.update().cpu()
        launches = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        assert s.locate_hit((128, 128), 0, 0)
        hit_launches = dict(kernels.LAUNCHES)
        out.append((img, s.viewer.models["golden.ply"].buffers.download_mask(),
                    s.measurement.hit_pairs[0].hits[0].pos, launches, hit_launches))
    (img_k, bits_k, hit_k, launches, hit_launches), (img_c, bits_c, hit_c, _, _) = out
    assert launches == _only(fused=1, sort=1, composite=composite_launches(32), overlay=1)
    assert hit_launches == _only(geometry=1)
    assert np.array_equal(bits_k, bits_c) and 0.05 < bits_k.mean() < 0.95
    assert_golden_close(_u8(img_k), _u8(img_c))
    assert np.abs(hit_k - hit_c).max() <= 1e-3 * ext


def test_gated_viewer_on_card_matches_cpu(dev):
    """Selection edit + highlight, committed edits and a mask: the frame
    through the kernels on the card vs the plain path on the CPU."""
    g = make_random_scene(20000, seed=3, extent=2.0, scale_range=(0.004, 0.03))
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.3, 0.2, -5.0))
    rng = np.random.default_rng(4)
    first, second, mask = (rng.random(g.count) < p for p in (0.4, 0.3, 0.8))
    imgs = []
    for device in (dev, "cpu"):
        v = Viewer(g, 256, 256, max_dup=8, device=device)
        b = v.models["model"].buffers
        b.set_selection(first.astype(np.uint8))
        b.commit_selection_edit(tedit.EDIT_FLAG_ENABLED, (0.3, 0.8, 1.1), (0.1, 0.3, 1.2, 0.7))
        b.set_selection(second.astype(np.uint8))
        b.set_mask(mask.astype(np.uint8))
        sel_edit, highlight = card.selection_pods(0.8)
        v.update_selection_edit(sel_edit)
        v.update_selection_highlight(highlight, True)
        kernels.reset_launch_counts()
        imgs.append(v.render(cam).cpu())
        if device == dev:
            assert kernels.LAUNCHES == _only(fused=1, sort=1, composite=composite_launches(32))
    assert_golden_close(_u8(imgs[0]), _u8(imgs[1]))


# --- K5 (enumerate and pack) and the model rank --------------------------------


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("d", [4, 8, 16, 20])
@pytest.mark.parametrize("bits,rank", [(0, 0), (2, 3)])
@pytest.mark.parametrize("n", [10_007, 100, 129])
def test_enum_pack_kernel_matches_plain(dev, tile, d, bits, rank, n):
    """K5 vs `enumerate_entries_from_pre_plain` on the same planes, every
    slot bit for bit: 10,007 splats (not a multiple of the 128-thread
    block), fewer than one block, and one over a block boundary; max_dup up
    to 20 (two rounds of the block's stage); wide enough to fall partly off
    screen, a quarter masked out (invalid); also into a row slice of a
    larger tensor."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, n, dev, seed=4, extent=4.0)
    view, proj = _camera(640, 360, pos=(0.3, 0.2, -4.0))
    mask = torch.from_numpy((np.arange(n) % 4 != 0).astype(np.uint8)).to(dev)
    pre = preprocess(pod, comp, view, proj, EYE, 640, 360, mask_bits=mask)
    n_valid = int(pre.valid.sum())
    assert 0 < n_valid < 0.7 * n  # masked and off-screen splats are invalid
    cfg = TileConfig(640, 360, tile=tile, max_dup=d, model_bits=bits)
    before = kernels.LAUNCHES["enum_pack"]
    got = enumerate_entries_from_pre(pre, cfg, model_rank=rank)
    assert kernels.LAUNCHES["enum_pack"] == before + 1
    ref = enumerate_entries_from_pre_plain(pre, cfg, model_rank=rank)
    assert got.shape == (n * d, 4) and got.dtype == torch.int32
    assert torch.equal(got, ref)
    keys = got[:, 0].to(torch.int64) & 0xFFFFFFFF
    live = keys != SENTINEL
    assert int(live.sum()) > n_valid // 2
    assert bool(((keys[live] >> cfg._rank_shift) & ((1 << bits) - 1) == rank).all())
    dead = got.view(n, d, 4)[~pre.valid]
    assert bool((dead[..., 0] == -1).all()) and int(dead[..., 1:].abs().sum()) == 0
    _check_into_slice(lambda out: enumerate_entries_from_pre(pre, cfg, model_rank=rank,
                                                             out=out), ref)
    compare_sorted(build_sorted_entries(pre, cfg, model_rank=rank), sort_entries_plain(ref, cfg),
                   stable=True)


def test_enum_pack_rejects_bad_inputs(dev):
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, 500, dev)
    view, proj = _camera(256, 256)
    pre = preprocess(pod, comp, view, proj, EYE, 256, 256)
    cfg = TileConfig(256, 256, tile=16, max_dup=4, model_bits=1)
    fields = {f: getattr(pre, f) for f in PreprocessOut.__dataclass_fields__}
    with pytest.raises(ValueError, match="depth"):
        enumerate_entries_from_pre(PreprocessOut(**dict(fields, depth=pre.depth.double())), cfg)
    with pytest.raises(ValueError, match="valid"):
        enumerate_entries_from_pre(PreprocessOut(**dict(fields, valid=pre.valid.to(torch.uint8))),
                                   cfg)
    with pytest.raises(ValueError, match="alpha"):
        enumerate_entries_from_pre(PreprocessOut(**dict(fields, alpha=pre.alpha.cpu())), cfg)
    with pytest.raises(ValueError, match="model_rank"):
        enumerate_entries_from_pre(pre, cfg, model_rank=2)
    with pytest.raises(ValueError, match="out"):
        enumerate_entries_from_pre(pre, cfg, out=torch.empty((10, 4), dtype=torch.int32,
                                                             device=dev))


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("n,d", [(30_001, 4), (100, 8), (129, 16)])
def test_fused_kernel_with_rank_matches_plain(dev, gated, n, d):
    """K1 with a model rank vs its plain version, every live slot, at
    max_dup 4, 8 and 16, fewer splats than one block and one over a block
    boundary; rank 0 under model_bits 0 writes the same low bits as before."""
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, n, dev, seed=2)
    view, proj = _camera(1920, 1088)
    gates = {}
    if gated:
        rng = np.random.default_rng(3)
        gates["mask_bits"] = torch.from_numpy((rng.random(n) > 0.25).astype(np.uint8)).to(dev)
    cfg = TileConfig(1920, 1088, tile=32, max_dup=d, model_bits=2)
    for rank in (0, 1, 3):
        got = enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, model_rank=rank, **gates)
        ref = enumerate_entries_plain(pod, comp, cfg, view, proj, EYE, model_rank=rank, **gates)
        st = compare_entries(got, ref, cfg)
        assert st["live_a"] > n // 4 and st["far"] == 0
        keys = got[:, 0].to(torch.int64) & 0xFFFFFFFF
        live = keys != SENTINEL
        assert bool(((keys[live] >> cfg._rank_shift) & 3 == rank).all())
    with pytest.raises(ValueError, match="model_rank"):
        enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, model_rank=4)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "staged"])
def test_merged_viewer_on_card_matches_cpu(dev, fused):
    """Three models merged on the card (either front-end route) vs the plain
    path on the CPU: the golden gate; and the launch counts of one frame."""
    models = [make_random_scene(5000, seed=i, extent=1.2, scale_range=(0.01, 0.04))
              for i in range(3)]
    views = {str(where): card.config2_viewer(models, where, fused, size=(320, 192),
                                             placements=((-1.0, 0.0), (0.0, 40.0), (1.0, -40.0)),
                                             tile=16, max_dup=8) for where in (dev, "cpu")}
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -4.5))
    kernels.reset_launch_counts()
    got = views[str(dev)].render(cam)
    front = {"fused": 3} if fused else {"preprocess": 3, "enum_pack": 3}
    assert kernels.LAUNCHES == _only(sort=1, composite=1, **front)
    assert_golden_close(_u8(got.cpu()), _u8(views["cpu"].render(cam)))


def _v1_pre(dev, n=600, w=256, h=192, mode=0, seed=4):
    comp = ALL_COMPRESSIONS[5]
    pod = _pod(comp, n, dev, seed=seed, extent=1.0, scale_range=(0.01, 0.06))
    view, proj = _camera(w, h, pos=(0.2, 0.3, -3.5))
    return preprocess(pod, comp, view, proj, EYE, w, h, display_mode=mode)


@pytest.mark.parametrize("tile,d", [(16, 16), (32, 4)])
def test_v1_sort_kernel_matches_torch_sort(dev, tile, d):
    """The v1 slots (tile | f32 depth bits, splat index) through K2 with the
    edges at cfg.depth_bits vs the plain stable torch.sort, row for row
    (both sorts are stable), equal tile ranges."""
    cfg = TileConfig(256, 192, tile=tile, max_dup=d)
    pre = _v1_pre(dev)
    ent = tile_list_entries(pre, cfg)
    before = kernels.LAUNCHES["sort"]
    got = sort_entries(ent, cfg, shift=cfg.depth_bits)
    assert kernels.LAUNCHES["sort"] == before + 1
    ref = sort_entries_plain(ent, cfg, shift=cfg.depth_bits)
    assert got.n_valid == ref.n_valid > 600
    compare_sorted(got, ref, stable=True)
    lists = build_tile_lists(pre, cfg)
    assert torch.equal(lists.sorted_idx, ref.entries[:, 1])


@pytest.mark.parametrize("tile,mode", [(16, 0), (32, 0), (16, 1), (32, 2)]
                         + [(tile, mode) for tile in (40, 64, 128, 256, 257, 320, 512)
                            for mode in (0, 1)])
def test_composite_v1_kernel_matches_plain(dev, tile, mode):
    """K6 vs its plain version on the same EntryPlanes, splat and flat; over
    32 px one block a tile up to 64, a cluster of 4 row bands at 128, of 16
    at 256; over 256 (one tile larger than the image) 32-px parts in two
    launches."""
    cfg = TileConfig(256, 192, tile=tile, max_dup=16)
    pre = _v1_pre(dev, mode=mode)
    planes = build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)
    before = kernels.LAUNCHES["composite_v1"]
    got = composite_tiles(planes, cfg, flat_mode=mode != 0)
    assert kernels.LAUNCHES["composite_v1"] == before + (2 if tile > 256 else 1)
    ref = composite_tiles_plain(planes, cfg, flat_mode=mode != 0)
    assert float(got[..., 3].mean()) > 0.05
    assert float((got - ref).abs().max()) <= K67_TOL


@pytest.mark.parametrize("mode", [0, 1])
def test_composite_v1_kernel_tile_closes_early_matches_plain(dev, mode):
    """K6 at tile 260 (32-px parts in two launches) where the tiles close
    before their last row (the plain version's rows read): pass 2 must stop
    at the tile's exit row."""
    comp = ALL_COMPRESSIONS[5]
    view, proj = _camera(520, 260, pos=(0.2, 0.3, -3.5))
    pre = preprocess(_faint_dense_pod(dev, comp), comp, view, proj, EYE, 520, 260,
                     display_mode=mode)
    cfg = TileConfig(520, 260, tile=260, max_dup=16)
    planes = build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)
    before = kernels.LAUNCHES["composite_v1"]
    got = composite_tiles(planes, cfg, flat_mode=mode != 0)
    assert kernels.LAUNCHES["composite_v1"] == before + 2
    work = {}
    ref = composite_tiles_plain(planes, cfg, flat_mode=mode != 0, stats=work)
    assert work["rows"] < int(((planes.tile_counts.long() + 127) // 128).sum())
    assert float(got[..., 3].min()) > 0.9
    assert float((got - ref).abs().max()) <= K67_TOL


def test_v1_wrappers_reject_bad_inputs(dev):
    cfg = TileConfig(256, 192, tile=16, max_dup=8)
    pre = _v1_pre(dev)
    planes = build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)
    with pytest.raises(ValueError, match="ent"):
        composite_tiles(dataclasses.replace(planes, ent=planes.ent.double()), cfg)
    with pytest.raises(ValueError, match="row_starts"):
        composite_tiles(dataclasses.replace(planes, row_starts=planes.row_starts.long()), cfg)
    with pytest.raises(ValueError, match="tile 0"):
        composite_tiles(planes, TileConfig(256, 192, tile=0, max_dup=8))


@pytest.mark.parametrize("h,w", [(1080, 1920), (23, 37)])
def test_jpeg_on_card_equals_cpu(dev, h, w):
    """The encoder's integer stages on the card give the CPU's file byte for
    byte, from an f32 frame (at config 1's size) through `frame_to_u8`."""
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    frame = torch.stack([torch.sin(xx / 37.0) * 0.5 + 0.5, (xx + yy) / (w + h),
                         torch.rand(h, w, generator=torch.Generator().manual_seed(0))], -1)
    frame[h // 3:h // 2] *= 1.3  # some values over 1 to clamp
    u8_k = jpeg.frame_to_u8(frame.to(dev))
    u8_c = jpeg.frame_to_u8(frame)
    assert torch.equal(u8_k.cpu(), u8_c)
    for q in (50, 85, 95):
        assert torch.equal(jpeg.coefficients(u8_k, q).cpu(), jpeg.coefficients(u8_c, q))
        assert jpeg.encode_jpeg(u8_k, q) == jpeg.encode_jpeg(u8_c, q)
    blob = jpeg.encode_frame(frame.to(dev), 85, 0.5)
    sof = blob.index(b"\xff\xc0")
    assert (int.from_bytes(blob[sof + 5:sof + 7], "big"),
            int.from_bytes(blob[sof + 7:sof + 9], "big")) == (round(h * 0.5), round(w * 0.5))


def test_traced_orbit_frame_counts_the_syncs_sync_debug_finds(dev):
    """Traced orbit frames of a small scene, eager, captured and replayed,
    wait for the device nowhere: torch's sync debug mode reports no
    synchronizing operation and no `host.read` span is recorded (K2 keeps
    its live count on the device, the background is a device tensor)."""
    import warnings

    g = make_random_scene(50_000, seed=4, extent=1.5, scale_range=(0.005, 0.03))
    v = Viewer(g, 320, 240, device=dev)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.4, 0.3, -4.5))
    v.render(cam)
    torch.cuda.synchronize()
    trace.reset()
    syncs = []
    for _ in range(3):   # eager (spans on: a new key), captured, replayed
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with trace.collect():
                    v.render(cam)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()   # the closed loop's own sync, outside the frame
        syncs += [w for w in caught if "called a synchronizing" in str(w.message)]
    recs = trace.records
    reads = [recs[r.parent].name for r in recs if r.name == "host.read"]
    assert trace.graph_frames == {"replayed": 1, "captured": 1, "eager": 1}
    assert reads == [] and syncs == []



def test_brush_frames_count_the_syncs_sync_debug_finds(dev):
    """The brush's pointer events and releases on a session on the card, in
    texture and in immediate mode, each with the frame that shows it: torch's
    sync debug mode reports no synchronizing operation and no `host.read`
    span is recorded: none in the frame (K2's live count stays on the
    device, the background is a device tensor), the paint, the resolve (K4,
    the texture's gather, the combine) or the immediate region test."""
    import warnings

    g = make_random_scene(50_000, seed=4, extent=1.5, scale_range=(0.005, 0.03))
    buf = io.BytesIO()
    write_ply(buf, g)
    s = GaussianSplattingSession(width=320, height=240, device=dev)
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    s.evaluate_mask(None)
    s.action = Action.SELECTION
    s.selection.method = SelectionMethod.BRUSH
    s.update()
    torch.cuda.synchronize()
    events = []
    for texture, op in ((True, QuerySelectionOp.SET), (False, QuerySelectionOp.ADD)):
        events += [lambda t=texture, o=op: (s.toolset.set_use_texture(t),
                                            s.toolset.start(QueryToolset.BRUSH, o, (100, 80))),
                   lambda: s.toolset.update_pos((130, 95)),
                   lambda: (s.toolset.update_pos((150, 120)), s.end_selection_gesture())]
    for event in events:
        trace.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with trace.collect():
                    event()
                    s.update()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = [w for w in caught if "called a synchronizing" in str(w.message)]
        recs = trace.records
        reads = [recs[r.parent].name for r in recs if r.name == "host.read"]
        assert reads == [] and syncs == []
    assert int(s.viewer.models["m.ply"].buffers.selection.sum()) > 0
    trace.reset()

def test_viewer_server_frame_jpeg_on_card(dev):
    """`frame_jpeg` on a session on the card: a dirty frame launches K1, K2
    and K3 once each and serves the encoding of the frame `update()` gives
    at that state; an idle poll launches nothing and serves the same bytes."""
    g = make_random_scene(50_000, seed=2, extent=1.5, scale_range=(0.005, 0.03))
    buf = io.BytesIO()
    write_ply(buf, g)
    s = GaussianSplattingSession(width=320, height=240, device=dev)
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    vs = ViewerServer(s)
    vs.frame_jpeg(85)  # warm-up
    vs.handle_event({"type": "orbit", "dx": 10.0, "dy": 0.0})
    kernels.reset_launch_counts()
    with trace.collect():
        blob = vs.frame_jpeg(85)
    assert dict(kernels.LAUNCHES) == _only(fused=1, sort=1, composite=composite_launches(32))
    assert set(vs.frame_ms) == {"update", "device", "copy", "host"}
    kernels.reset_launch_counts()
    assert vs.frame_jpeg(85) is blob and dict(kernels.LAUNCHES) == _only()
    want = jpeg.encode_jpeg(jpeg.frame_to_u8(s.update()).cpu(), 85)
    assert blob == want and blob[:2] == b"\xff\xd8" and len(blob) > 2000


def test_sharded_frame_on_card_matches_render_frame(dev):
    """`parallel.render_sharded` over NCCL at world size 1 (an in-process
    group): a mesh of one rank on the card; K8 and K5 once, K2 twice (local
    and owner sort), K3 once, no overflow, and the image bit for bit
    `render_frame`'s; the merged two-model frame likewise against the
    single-device merged entries on the plain preprocess."""
    import torch.distributed as dist

    from wgpu_3dgs_viewer_app_tpu_torch.parallel import (make_mesh, render_frame_sharded_multi,
                                                         render_sharded, shard_pod)
    from wgpu_3dgs_viewer_app_tpu_torch.parallel.render_sharded import last_stats

    comp = ALL_COMPRESSIONS[5]
    cfg = TileConfig(256, 200, tile=16, max_dup=8)
    view, proj = _camera(256, 200)
    words = [flat_pod_to_words(pack_gaussians(make_random_scene(n, seed=s, extent=1.5), comp),
                               comp) for n, s in ((20_000, 1), (7_000, 2))]
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.world == 1 and mesh.device.type == "cuda"
        pods = [shard_pod(w, mesh) for w in words]
        kernels.reset_launch_counts()
        img = render_sharded(pods[0], mesh, comp, cfg, view, proj, sh_degree=3)
        assert dict(kernels.LAUNCHES) == _only(preprocess=1, enum_pack=1, sort=2, composite=1)
        assert last_stats() == {"overflow": 0, "n_devices": 1}
        ref = render_frame(pods[0], comp, cfg, view, proj, EYE, sh_degree=3)
        assert torch.equal(img, over_background(ref, (0.0, 0.0, 0.0)))
        models = np.stack([EYE, EYE])
        models[1, 2, 3] = 0.4
        img, overflow = render_frame_sharded_multi(pods, mesh, "splats", comp, cfg, view, proj,
                                                   models, [1, 0], np.zeros(3, np.float32))
        assert overflow == 0
        cfg_m = dataclasses.replace(cfg, model_bits=1)
        parts = [enumerate_entries_from_pre(preprocess(p, comp, view, proj, m, 256, 200), cfg_m,
                                            model_rank=r)
                 for p, m, r in zip(pods, models, (1, 0))]
        want = composite_tiles_v2(sort_entries(torch.cat(parts), cfg_m), cfg_m)
        assert torch.equal(img[:200], over_background(want, (0.0, 0.0, 0.0)))
    finally:
        dist.destroy_process_group()


OVERLAY_STAGES = ["lines", "lines+tint", "lines+tint+ring", "ring"]


def _overlay_inputs(h: int, w: int, m: int, seed: int = 0):
    """A random frame, m segments at most 256 px long with widths 0-8 (one
    alone starts inside the frame; among 8 or more, a dead, a transparent,
    an off-screen, a NaN-ended, an inf-ended and a zero-length one), a
    selection texture, a ring."""
    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.random((h, w, 3)).astype(np.float32))
    a = (rng.random((m, 2)) * [w * 1.2, h * 1.2] - [w * 0.1, h * 0.1]).astype(np.float32)
    ang, length = rng.random(m) * 2 * np.pi, rng.random(m) * 256.0
    b = (a + np.stack([np.cos(ang), np.sin(ang)], 1) * length[:, None]).astype(np.float32)
    col = rng.random((m, 4)).astype(np.float32)
    col[::5, 3] = 1.0
    lw = (rng.random(m) * 8.0).astype(np.float32)
    live = np.ones(m, bool)
    if m == 1:
        a[0] = (w * 0.3, h * 0.4)
    if m >= 8:
        live[0] = False
        col[1, 3] = 0.0
        a[2], b[2] = (-300.0, -300.0), (-280.0, -290.0)
        a[3, 0], b[4, 1] = np.nan, np.inf
        b[5] = a[5]
        lw[6] = 0.0
    tex = torch.from_numpy(rng.random((h, w)) < 0.3)
    center = np.array([w * 0.45 + 0.3, h * 0.55 - 0.2], np.float32)
    return img, (a, b, col, lw, live), tex, center, float(min(h, w)) * 0.2


@pytest.mark.parametrize("m", [0, 1, 121, 600])
@pytest.mark.parametrize("stages", OVERLAY_STAGES)
@pytest.mark.parametrize("h,w", [(96, 128), (1088, 1920)])
def test_overlay_kernel_matches_plain(dev, h, w, stages, m):
    """K9 in one launch against the plain versions run in turn on the card,
    bit for bit (max abs 0), into a new image."""
    img, segs, tex, center, radius = _overlay_inputs(h, w, m)
    img, tex = img.to(dev), tex.to(dev)
    want, table, texture, cursor = img, None, None, None
    if "lines" in stages:
        want = rasterize_lines_plain(want, *segs)
        table = segment_table(*segs, w, h)
    if "tint" in stages:
        want, texture = overlay_texture_plain(want, tex), tex
    if "ring" in stages:
        want = overlay_cursor_ring_plain(want, center, radius)
        cursor = (center, radius)
    kernels.reset_launch_counts()
    got = overlay_cuda(img, table, texture, cursor=cursor)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _only(overlay=1)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.data_ptr() != img.data_ptr()   # a new image, also with nothing to draw
    if stages == "lines":
        assert torch.equal(rasterize_lines(img, *segs), got)
    if m and "lines" in stages:
        assert not torch.equal(got, img)


def test_overlay_wrapper_rejects_bad_inputs(dev):
    img, segs, tex, center, radius = _overlay_inputs(32, 48, 10)
    img, tex = img.to(dev), tex.to(dev)
    table = segment_table(*segs, 48, 32)
    for bad in (img.double(), img.cpu(), img.transpose(0, 1).contiguous().transpose(0, 1),
                img[..., :2].contiguous()):
        with pytest.raises(ValueError, match="img"):
            overlay_cuda(bad, table)
    for bad in (tex.to(torch.uint8), tex.cpu(), tex[:16].contiguous()):
        with pytest.raises(ValueError, match="texture"):
            overlay_cuda(img, table, bad)
    for bad in (table.astype(np.float64), table[:, :12].copy(), torch.from_numpy(table)):
        with pytest.raises(ValueError, match="table"):
            overlay_cuda(img, bad)
    kernels.reset_launch_counts()
    overlay_cuda(img, table[:0], cursor=(center, radius))
    assert kernels.LAUNCHES == _only(overlay=1)


def test_session_overlays_on_card_match_cpu(dev):
    """The session's overlays (gizmos of two shapes, a measurement pair, a
    brush gesture in texture mode: the tint and the ring) as one K9 launch,
    bit for bit the plain versions on the card and within 1e-5 of the CPU
    session (torch's CPU sqrt in f32, in the ring, is an ulp off now and
    then); then `update()` with a model: K1, K2, K3 and K9 once each."""
    g = make_random_scene(3000, seed=4, extent=1.0, scale_range=(0.01, 0.04))
    buf = io.BytesIO()
    write_ply(buf, g)
    img = torch.from_numpy(np.random.default_rng(1).random((120, 160, 3)).astype(np.float32))
    out = {}
    for device in ("cpu", dev):
        s = GaussianSplattingSession(width=160, height=120, device=device)
        s.camera.control.pos = np.array([0.4, 0.3, -3.0], np.float32)
        s.viewer.update_camera(s.camera.control)
        s.mask.add_shape(MaskShape(kind=MaskShapeKind.BOX, scale=np.full(3, 1.4, np.float32)))
        s.mask.add_shape(MaskShape(kind=MaskShapeKind.ELLIPSOID,
                                   pos=np.array([0.4, 0.0, 0.0], np.float32)))
        pair = MeasurementHitPair(label="p", line_width=2.5)
        pair.hits[0].pos = np.array([-0.6, 0.1, 0.0], np.float32)
        pair.hits[1].pos = np.array([0.5, -0.2, 0.3], np.float32)
        s.measurement.hit_pairs.append(pair)
        s.action = Action.SELECTION
        s.selection.method = SelectionMethod.BRUSH
        s.selection.brush_radius = 14
        s.toolset.update_brush_radius(14.0)
        s.toolset.set_use_texture(True)
        s.toolset.start(QueryToolset.BRUSH, QuerySelectionOp.ADD, (30.0, 40.0))
        s.toolset.update_pos((110.0, 70.0))
        kernels.reset_launch_counts()
        out[str(device)] = s.render_overlays(img.to(device)).cpu()
        launches = dict(kernels.LAUNCHES)
    assert launches == _only(overlay=1)
    view, proj = s.viewer._view, s.viewer._proj
    lines = [np.concatenate(f) for f in zip(*(x for x in (
        gizmo_lines(s.mask.shapes, view, proj, 160, 120),
        measurement_lines(s.measurement, view, proj, 160, 120))))]
    want = rasterize_lines_plain(img.to(dev), *lines)
    want = overlay_texture_plain(want, s.toolset.texture)
    want = overlay_cursor_ring_plain(want, np.float32([110.0, 70.0]), 14.0).cpu()
    got, cpu = out[str(dev)], out["cpu"]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert float((got - cpu).abs().max()) <= 1e-5 and not torch.equal(got, img)
    s.open_model("m.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    kernels.reset_launch_counts()
    frame = s.update()
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == _only(fused=1, sort=1, composite=composite_launches(32), overlay=1)
    assert frame.shape == (120, 160, 3) and bool(torch.isfinite(frame).all())


# --- the viewer's frame as a replayed CUDA graph (viewer/graph.py) -----------------


def _eager_frame(v, cam, show_unedited=False):
    """The viewer's frame issued eager (a key never seen), through the same
    launchers and frame buffers as its graph."""
    g = v._graphs
    keep = {} if g is None else dict(g.graphs)
    if g is not None:
        g.graphs.clear()
        g.last_key = None
    before = dict(trace.graph_frames)
    with trace.collect():
        img = v.render(cam, show_unedited=show_unedited)
    assert trace.graph_frames["eager"] == before["eager"] + 1
    v._graphs.graphs.update(keep)
    v._graphs.last_key = None
    return img


def _replayed_frame(v, cam, show_unedited=False):
    """The viewer's frame, issued until it is a replay of a kept graph."""
    for _ in range(3):
        before = dict(trace.graph_frames)
        with trace.collect():
            img = v.render(cam, show_unedited=show_unedited)
        if trace.graph_frames["replayed"] == before["replayed"] + 1:
            return img
    raise AssertionError("the frame was never replayed")


def _orbit(yaw, radius, height=1.0):
    return CameraOrbitControl(target=(0, 0, 0), pos=(radius * math.sin(yaw), height,
                                                     -radius * math.cos(yaw)))


def test_replayed_frames_equal_eager_frames_over_an_orbit(dev):
    """Over 36 yaws of an inria-like scene, each replayed frame equals the
    same frame issued eager and the launch-by-launch frame of `render_model`
    (fresh buffers, K1's own record), bit for bit; a replay counts one launch
    of K1 and K2 and K3's two."""
    from wgpu_3dgs_viewer_app_tpu_torch.data.synthetic import make_inria_like_scene

    v = Viewer(make_inria_like_scene(200_000, seed=2), 640, 360, device=dev,
               background=(0.1, 0.2, 0.3))
    trace.reset()
    v.render(_orbit(0.0, 6.0))
    for k in range(36):
        cam = _orbit(k * math.pi / 18, 6.0)
        replayed = _replayed_frame(v, cam)
        kernels.reset_launch_counts()
        again = _replayed_frame(v, cam)
        assert kernels.LAUNCHES == _only(fused=1, sort=1, composite=composite_launches(32))
        eager = _eager_frame(v, cam)
        plain = over_background(v.render_model("model"), v.background_tensor)
        torch.cuda.synchronize()
        for img in (again, eager, plain):
            assert torch.equal(replayed.view(torch.int32), img.view(torch.int32)), k


def test_replayed_merged_frames_equal_eager_through_order_changes(dev):
    """Three models around the middle one: along the orbit the models' order
    changes with no new capture (each model's rank rides the block), and
    every replayed frame equals the eager frame and the launch-by-launch
    merged frame (`_render_merged`, order-laid rows), bit for bit."""
    v = MultiModelViewer(480, 272, device=dev)
    for i in range(3):
        g = make_random_scene(60_000, seed=10 + i, extent=1.0, scale_range=(0.005, 0.03))
        v.add_model(f"m{i}", g)
        v.update_model_transform(f"m{i}", ModelTransform(
            pos=np.array([2.0 * i - 2.0, 0, 0], np.float32),
            rot=np.array([0, 40.0 * (i - 1), 0], np.float32)))
        v.models[f"m{i}"].buffers.set_edits(*tedit.make_edit_soa(g.count))
    trace.reset()
    orders = set()
    for k in range(24):
        cam = _orbit(k * math.pi / 12, 7.0)
        before = dict(trace.graph_frames)
        replayed = _replayed_frame(v, cam)
        if k > 0:
            assert trace.graph_frames["captured"] == before["captured"]
        orders.add(tuple(v.model_order()))
        eager = _eager_frame(v, cam)
        merged = v._render_merged(v.model_order(), False)
        torch.cuda.synchronize()
        for img in (eager, merged):
            assert torch.equal(replayed.view(torch.int32), img.view(torch.int32)), k
    assert len(orders) > 1


def test_replayed_gated_frames_follow_the_gates(dev):
    """A gated frame (mask, selection, a selection edit, the highlight) is
    replayed while the mask is dragged, the rect selection changes and the
    selection edit and highlight change (written in place or riding the
    block), and equals the eager frame of the same state each time, bit for
    bit; `show_unedited` is a key of its own."""
    g = make_random_scene(80_000, seed=6, extent=1.5, scale_range=(0.005, 0.03))
    v = Viewer(g, 320, 240, device=dev)
    b = v.models["model"].buffers
    rng = np.random.default_rng(1)
    b.set_mask(rng.random(g.count) < 0.7)
    b.set_selection(rng.random(g.count) < 0.3)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.4, 0.3, -4.5))
    trace.reset()
    for step in range(6):
        ptrs = (b.mask.data_ptr(), b.selection.data_ptr())
        b.set_mask(rng.random(g.count) < 0.5 + 0.05 * step)               # a mask drag
        b.set_selection(np.asarray(g.pos[:, 0] > -0.5 + 0.2 * step))      # a rect
        assert (b.mask.data_ptr(), b.selection.data_ptr()) == ptrs
        v.update_selection_edit(tedit.GaussianEditPod(
            flags=1 | 4 * (step % 2), rgb_or_hsv=tuple(rng.random(3)),
            contrast=float(rng.random()), alpha=float(rng.random())))
        v.update_selection_highlight(tedit.SelectionHighlightPod(rgba=tuple(rng.random(4))))
        for unedited in (False, True):
            replayed = _replayed_frame(v, cam, unedited)
            eager = _eager_frame(v, cam, unedited)
            torch.cuda.synchronize()
            assert torch.equal(replayed.view(torch.int32), eager.view(torch.int32)), step


def test_two_renders_without_a_sync_are_both_right(dev):
    """Two frames issued back to back with no sync between them (the second
    writes the parameter block while the first may still run) both equal
    their eager frames."""
    g = make_random_scene(100_000, seed=7, extent=1.5, scale_range=(0.005, 0.03))
    v = Viewer(g, 640, 360, device=dev)
    cams = [_orbit(0.3 * k, 4.5, 0.3) for k in range(6)]
    for cam in cams[:3]:
        v.render(cam)
    torch.cuda.synchronize()
    frames = [v.render(cam) for cam in cams]
    torch.cuda.synchronize()
    for cam, img in zip(cams, frames):
        assert torch.equal(img.view(torch.int32), _eager_frame(v, cam).view(torch.int32))


# --- paths no benchmark cell runs, end to end on the card at small sizes ----------------

EXIT_TOL = 1.0 / 255.0 + 1e-5   # what a tile's chunk exit may leave out of a channel


def _frame_ok(img, w, h, min_coverage):
    """Shape, finite values and the share of covered pixels of a frame."""
    assert img.shape == (h, w, 3) and bool(torch.isfinite(img).all())
    coverage = float((img.amax(dim=-1) > 1.0 / 255.0).float().mean())
    assert coverage > min_coverage, coverage


def test_cli_render_on_card_meets_golden_and_orbit_sequence(dev, tmp_path):
    """`render --device cuda` on the golden fixture meets the golden gate
    against tests/golden/golden_256.png; `--frames 3 --orbit-step 20` writes
    three distinct frames, each byte for byte the single render at its yaw."""
    from wgpu_3dgs_viewer_app_tpu_torch.app.cli import main as cli
    from wgpu_3dgs_viewer_app_tpu_torch.utils.png import read_png

    g = read_ply(os.path.join(REPO, "tests", "fixtures", "trained_like_100k.ply"))
    ply = str(tmp_path / "golden_20k.ply")
    with open(ply, "wb") as f:
        write_ply(f, g.select(np.arange(g.count) < 20_000))  # as scripts/gen_golden.py crops
    args = ["render", ply, "--width", "256", "--height", "256", "--max-dup", "16",
            "--device", "cuda"]
    assert cli(args + ["-o", str(tmp_path / "golden.png"), "--orbit", "30"]) == 0
    gold = read_png(os.path.join(REPO, "tests", "golden", "golden_256.png"))
    assert_golden_close(read_png(str(tmp_path / "golden.png")).astype(np.int16),
                        gold.astype(np.int16))
    assert cli(args + ["-o", str(tmp_path / "seq.png"), "--frames", "3",
                       "--orbit-step", "20"]) == 0
    frames = []
    for i in range(3):
        assert cli(args + ["-o", str(tmp_path / f"single_{i}.png"), "--orbit", str(20 * i)]) == 0
        frames.append((tmp_path / f"seq_{i:03d}.png").read_bytes())
        assert frames[-1] == (tmp_path / f"single_{i}.png").read_bytes(), i
    assert len(set(frames)) == 3


def test_selection_step_on_card(dev):
    """BASELINE config 3's step (K4 -> `select_rect` -> a selection edit and
    highlight -> `Viewer.render`) changes the rect's pixels and no far one;
    then a brush ADD, a texture-mode rect resolved as `select_rect` within
    1%, committed edits rendering as the live edit, `show_unedited` as the
    ungated frame, half the splats masked, and hits matching the CPU's."""
    w, h = 1280, 720
    rect = ((w * 0.21, h * 0.19), (w * 0.73, h * 0.74))  # config 3's, at this size
    g = make_random_scene(600_000, seed=1, extent=2.0, scale_range=(0.004, 0.02))
    v = Viewer(g, w, h, tile=32, max_dup=4, device=dev)
    v.update_camera(CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6)))
    m = v.models["model"]
    b = m.buffers
    # Alpha 1: a selected splat's tail can reach past the far check's 70-px
    # margin, where a lower alpha moves pixels by rounding (2.4e-7, the CPU too).
    sel_edit, highlight = card.selection_pods(1.0)

    def geometry(**kw):
        return preprocess_geometry_fused(b.pod, v.comp, v._view, v._proj, m.transform.matrix(),
                                         w, h, display_mode=0, **kw)

    def ungated():
        se = build_sorted_entries_fused(b.pod, v.comp, v.cfg, v._view, v._proj,
                                        m.transform.matrix())
        return over_background(composite_tiles_v2(se, v.cfg), v.background)

    kernels.reset_launch_counts()
    img, pre, bits = card.config3_step(v, rect)()
    assert kernels.LAUNCHES == _only(geometry=1, fused=1, sort=1,
                                     composite=composite_launches(32))
    _frame_ok(img, w, h, 0.2)
    selected = int(bits.sum())
    assert 0 < selected < g.count
    plain = ungated()
    (x0, y0), (x1, y1) = rect
    far = torch.ones((h, w), dtype=torch.bool, device=img.device)
    far[max(int(y0) - 70, 0):int(y1) + 70, max(int(x0) - 70, 0):int(x1) + 70] = False
    assert torch.equal(img[far], plain[far])
    inside = (img - plain)[int(y0) + 35:int(y1) - 35, int(x0) + 35:int(x1) - 35]
    assert float(inside.abs().mean()) > 0.02

    ts = QueryToolset(w, h, device=dev)   # a brush stroke, ADD, in immediate mode
    ts.update_brush_radius(20.0)
    ts.start(QueryToolset.BRUSH, QuerySelectionOp.ADD, (w * 0.1, h * 0.83))
    ts.update_pos((w * 0.88, h * 0.88))
    ts.end()
    sel = b.selection
    for pod in ts.query():
        sel = apply_query_pod(pre, sel, pod)
    assert int(sel.sum()) > selected and bool((sel >= b.selection).all())
    b.set_selection(sel)
    ts.set_use_texture(True)   # a rect painted into the query texture
    a, z = (w * 0.3, h * 0.2), (w * 0.7, h * 0.8)
    ts.start(QueryToolset.RECT, QuerySelectionOp.ADD, a)
    ts.update_pos(z)
    op, tex = ts.end()
    tex_bits, rect_bits = sample_texture_at_centers(pre, tex), select_rect(pre, a, z)
    mismatch = int((tex_bits != rect_bits).sum())
    assert int(tex_bits.sum()) > 0 and mismatch <= 0.01 * int(rect_bits.sum()), mismatch
    b.set_selection(combine_selection(b.selection, tex_bits, op))

    live = v.render()
    b.commit_selection_edit(*sel_edit.as_arrays())
    v.update_selection_edit(None)
    assert torch.equal(v.render(), live)
    v.update_selection_highlight(highlight, False)
    unedited = v.render(show_unedited=True)
    assert torch.equal(unedited, ungated())
    edited = v.render()
    assert not torch.equal(unedited, edited)

    b.set_mask((np.arange(g.count) % 2).astype(np.uint8))
    masked = v.render()
    _frame_ok(masked, w, h, 0.1)
    assert not torch.equal(masked, edited)
    kernels.reset_launch_counts()
    masked_pre = geometry(mask_bits=b.mask, edit=(b.edit_flags, b.edit_rgb, b.edit_params))
    assert kernels.LAUNCHES == _only(geometry=1)
    n_valid, n_all = int(masked_pre.valid.sum()), int(pre.valid.sum())
    assert abs(n_valid - n_all / 2) <= 0.01 * n_all
    cpu_pre = type(masked_pre)(**{f: getattr(masked_pre, f).cpu()
                                  for f in masked_pre.__dataclass_fields__})
    for method in MeasurementHitMethod:
        found, pos = query_hit(masked_pre, (w / 2, h / 2), v._view, v._proj, w, h, method)
        found_c, pos_c = query_hit(cpu_pre, (w / 2, h / 2), v._view, v._proj, w, h, method)
        assert bool(found) and bool(found_c), method
        assert float((pos.cpu() - pos_c).abs().max()) <= 1e-4, method


def test_merged_frame_on_card_routes_order_and_compressions(dev):
    """BASELINE config 2 merged on the card: the staged route within the
    golden gate of the fused; the frame within a chunk exit a model of the
    models blended back to front under its key layout; a hidden model, an
    order flip (the moved model takes rank 0), a resize, and two
    compressions (edits kept; pods and frame bit for bit a fresh viewer's;
    half SH within the golden gate; f32 covariance keeps what f16 flushes)."""
    n, (w, h) = 100_000, (960, 544)
    models = [make_random_scene(n, seed=i, extent=1.5, scale_range=(0.004, 0.02))
              for i in range(3)]
    v = card.config2_viewer(models, dev, size=(w, h))
    order = v.model_order()
    cfg_m = v.merged_config(3)
    assert len(order) == 3 and cfg_m.model_bits == 2
    v.fused = False
    staged = v.render()
    v.fused = True
    merged = v.render()
    _frame_ok(merged, w, h, 0.2)
    assert_golden_close(_u8(staged.cpu()), _u8(merged.cpu()))
    entries, cfg = v.merged_entries(order)
    assert cfg == cfg_m and entries.shape[0] == 3 * n * cfg_m.max_dup
    del entries
    acc = None
    for key in order:   # back to front, "over"
        img = v._composite(v._model_entries(key, cfg_m, 0, False), cfg_m)
        acc = img if acc is None else img + (1.0 - img[..., 3:4]) * acc
    assert float((merged - over_background(acc, v.background)).abs().max()) <= 4 * EXIT_TOL

    v.models["m1"].visible = False
    assert v.merged_config(len(v.model_order())).model_bits == 1
    assert float((v.render() - merged).abs().max()) > 0.05
    v.models["m1"].visible = True
    far = order[0]
    old = v.models[far].transform
    v.update_model_transform(far, dataclasses.replace(old, pos=np.float32([0.0, 0.0, -3.0])))
    flipped = v.model_order()
    assert flipped[-1] == far and flipped != order
    ent, _ = v.merged_entries(flipped)
    rows = n * cfg_m.max_dup
    k_far = ent[flipped.index(far) * rows:(flipped.index(far) + 1) * rows, 0].to(torch.int64)
    k_far = k_far[k_far != -1] & 0xFFFFFFFF
    assert k_far.numel() > 0 and bool(((k_far >> cfg_m._rank_shift) & 3 == 0).all())
    del ent, k_far
    assert float((v.render() - merged).abs().max()) > 0.05
    v.update_model_transform(far, old)
    assert v.model_order() == order
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -7))
    v.resize(640, 360)
    v.update_camera(cam)
    _frame_ok(v.render(), 640, 360, 0.2)
    v.resize(w, h)
    v.update_camera(cam)

    flags_before = [v.models[k].buffers.edit_flags for k in order]
    cov_half = [cov3d_components(v.models[k].buffers.pod) for k in order]
    for comp in (Compressions(ShCompression.HALF, Cov3dCompression.HALF),
                 Compressions(ShCompression.HALF, Cov3dCompression.SINGLE)):
        v.set_compressions(comp)
        assert v.comp == comp and all(v.models[k].buffers.comp == comp for k in order)
        assert all(v.models[k].buffers.edit_flags is f for k, f in zip(order, flags_before))
        repacked = v.render()
        _frame_ok(repacked, w, h, 0.2)
        assert not torch.equal(repacked, v.render(show_unedited=True))
        fresh = card.config2_viewer(models, dev, comp=comp, size=(w, h))
        assert all(torch.equal(t, fresh.models[k].buffers.pod[name]) for k in order
                   for name, t in v.models[k].buffers.pod.items())
        assert torch.equal(repacked, fresh.render())
        del fresh
        if comp.cov3d == Cov3dCompression.HALF:
            assert_golden_close(_u8(repacked.cpu()), _u8(merged.cpu()))
            assert float((repacked - merged).abs().mean()) < 1.0 / 255.0
        else:   # the f16 decoder reads subnormals (terms under 6.1e-5) as 0
            assert sum(int(((a == 0) & (b != 0)).sum()) for k, half in zip(order, cov_half)
                       for a, b in zip(half, cov3d_components(v.models[k].buffers.pod))) > 0


def test_v1_and_row_major_frames_on_card(dev):
    """The v1 chain (K8 -> `build_tile_lists` (K2) -> `build_entry_planes` ->
    `composite_tiles` (K6)) and the row-major v2 frame (K1 -> K2 ->
    `composite_tiles_v2(transposed=False, mxu=True)`): each launches its
    kernels once (K3 its two passes) and meets the golden gate against the
    same chain on the CPU."""
    w, h = 960, 540
    g = make_random_scene(200_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0, 0, -6))
    view, proj = cam.view(), cam.projection(w / h)
    cfg = TileConfig(w, h, tile=32, max_dup=4)
    comp = Compressions()
    words = flat_pod_to_words(pack_gaussians(g, comp), comp)
    frames = {}
    for where in (torch.device("cpu"), dev):   # the card's last: its launch counts are read
        pod = pod_to_tensors(words, where)
        kernels.reset_launch_counts()
        pre = preprocess_fused(pod, comp, view, proj, EYE, w, h)
        v1 = composite_tiles(build_entry_planes(pre, build_tile_lists(pre, cfg), cfg), cfg)
        v1_launches = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        rows = composite_tiles_v2(build_sorted_entries_fused(pod, comp, cfg, view, proj, EYE),
                                  cfg, transposed=False, mxu=True)
        rows_launches = dict(kernels.LAUNCHES)
        frames[where.type] = [over_background(x, (0.0, 0.0, 0.0)).cpu() for x in (v1, rows)]
        del pod, pre
    assert v1_launches == _only(preprocess=1, sort=1, composite_v1=1)
    assert rows_launches == _only(fused=1, sort=1, composite=composite_launches(32))
    for card, cpu in zip(frames["cuda"], frames["cpu"]):
        _frame_ok(card, w, h, 0.2)
        assert_golden_close(_u8(card), _u8(cpu))


def _masked_session(dev, g, w, h):
    """An app session on `dev`: `g` streamed in from PLY bytes, the camera at
    (0, 0, -6) on the origin, config 4's mask through the command bus."""
    buf = io.BytesIO()
    write_ply(buf, g)
    s = GaussianSplattingSession(width=w, height=h, device=dev, tile=32, max_dup=4)
    s.camera.control.target = np.zeros(3, np.float32)
    s.camera.control.pos = np.array([0.0, 0.0, -6.0], np.float32)
    s.open_model("scene.ply", io.BytesIO(buf.getvalue()))
    while s.loader is not None:
        s._drain_loader()
    unmasked = s.viewer.render(s.camera.control)
    for kind, pos, scale in card.CONFIG4_SHAPES:
        s.mask.add_shape(MaskShape(kind=MaskShapeKind(kind), pos=np.array(pos, np.float32),
                                   scale=np.full(3, scale, np.float32)))
    s.mask.op_code = card.CONFIG4_OP
    s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=s.mask.parse_op()))
    s._drain_commands()
    return s, s.viewer.models["scene.ply"], unmasked


def test_session_mask_export_reset_and_gesture_on_card(dev):
    """BASELINE config 4's session: the scene streamed in whole; the masked
    frame within 1e-5 of the kept splats alone; two hits (K4 twice) make a
    pair whose line the next frame draws; the masked export holds the kept
    splats; Reset renders the unmasked frame; a rect gesture launches K4
    once and a committed edit follows the selection."""
    w, h = 960, 544
    g = make_random_scene(1_500_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    s, m, unmasked = _masked_session(dev, g, w, h)
    assert len(m.buffers) == g.count and np.array_equal(m.gaussians.pos, g.pos)
    bits = m.buffers.download_mask().astype(bool)
    kept = int(bits.sum())
    assert 0 < kept < g.count
    img = s.update()
    _frame_ok(img, w, h, 0.01)
    cam = s.camera.control
    masked = s.viewer.render(cam)
    only = Viewer(g.select(bits), w, h, tile=32, max_dup=4, device=dev).render(cam)
    assert float((masked - only).abs().max()) <= 1e-5
    assert not torch.equal(masked, unmasked)
    del only

    kernels.reset_launch_counts()
    hits = ((w * 0.5, h * 0.5), (w * 0.552, h * 0.533))   # config 4's, at this size
    assert [s.locate_hit(px, 0, i) for i, px in enumerate(hits)] == [True, True]
    assert kernels.LAUNCHES == _only(geometry=2)
    dist = s.measurement.hit_pairs[0].distance()
    assert math.isfinite(dist) and dist > 0
    assert int(((s.update() - img).abs().amax(dim=-1) > 0).sum()) > 0
    out = io.BytesIO()
    export_models(s.viewer, out, {"scene.ply": ExportChoice(with_edit=False, with_mask=True)})
    header = read_ply_header(io.BytesIO(out.getvalue()))
    assert header.count == kept and len(out.getvalue()) == header.header_len + kept * 248

    s.send_command(SceneCommand(SceneCommandKind.EVALUATE_MASK, mask_op=None))   # Reset
    s._drain_commands()
    assert bool(m.buffers.mask.all())
    reset = s.viewer.render(cam)
    assert torch.equal(reset, unmasked)
    s.action = Action.SELECTION
    s.toolset.set_use_texture(False)
    s.toolset.start(QueryToolset.RECT, QuerySelectionOp.SET, (w * 0.21, h * 0.19))
    s.toolset.update_pos((w * 0.73, h * 0.74))
    kernels.reset_launch_counts()
    s.end_selection_gesture()
    assert kernels.LAUNCHES == _only(geometry=1)
    assert 0 < int(m.buffers.selection.sum()) < g.count
    s.selection.edit = SelectionEdit(hsv=(0.3, 1.0, 1.0), alpha=0.5)
    s.commit_selection_edit()
    flags = m.buffers.download_edits()[0]
    sel = m.buffers.download_selection().astype(bool)
    assert bool((flags[sel] != 0).all()) and not (flags[~sel] != 0).any()
    s.selection.edit = None
    assert not torch.equal(s.update(), reset)


def test_viewer_server_over_http_on_card(dev):
    """The web viewer over HTTP (an ephemeral port on 127.0.0.1) on a masked
    session on the card: the page, `/state`'s counts, the mask over
    `/command`, a half-scale frame, the first-person camera, a rect
    selection over `/event` (K4 once) and a committed edit, the masked
    export, and a change of compression over `/set`, after which a dirty
    frame launches K1, K2, K3's two passes and K9 (the gizmos) once."""
    import threading
    import urllib.request
    from http.server import ThreadingHTTPServer

    from wgpu_3dgs_viewer_app_tpu_torch.app.server import ASSETS
    from wgpu_3dgs_viewer_app_tpu_torch.utils import human_readable_size

    w, h = 640, 368
    g = make_random_scene(300_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    s, m, _ = _masked_session(dev, g, w, h)
    kept = int(m.buffers.mask.sum())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(ViewerServer(s)))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def call(path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{httpd.server_address[1]}{path}",
                                     data=data, method="GET" if data is None else "POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.read()

    def ok(path, body):
        assert json.loads(call(path, body)) == {"ok": True}, (path, body)

    def size_of(blob):   # (width, height) from a baseline JPEG's SOF0 header
        i = blob.index(b"\xff\xc0")
        return int.from_bytes(blob[i + 7:i + 9], "big"), int.from_bytes(blob[i + 5:i + 7], "big")

    try:
        assert call("/") == (ASSETS / "index.html").read_bytes()
        model = json.loads(call("/state"))["models"]["scene.ply"]
        assert model["count"] == model["loaded"] == g.count
        assert model["compressed_size"] == human_readable_size(
            s.compressions.compressed_size(g.count))
        ok("/command", {"cmd": "evaluate_mask"})
        assert int(m.buffers.mask.sum()) == kept
        blob = call("/frame.jpg?quality=85")
        assert size_of(call("/frame.jpg?quality=85&scale=0.5")) == (w // 2, h // 2)
        ok("/event", {"type": "set_control", "control": "first_person"})
        ok("/event", {"type": "look", "dx": 40.0, "dy": -10.0})
        ok("/event", {"type": "move", "z": 1.0, "x": 0.3, "dt": 0.2})
        assert json.loads(call("/state"))["camera"]["control"] == "first_person"
        assert call("/frame.jpg?quality=85") != blob
        ok("/event", {"type": "set_control", "control": "orbit", "arm": 6.0})
        assert json.loads(call("/state"))["camera"]["control"] == "orbit"

        ok("/set", {"action": "selection",
                    "selection": {"edit": {"hsv": [0.6, 1.0, 1.0], "alpha": 0.8}}})
        call("/frame.jpg?quality=85")
        kernels.reset_launch_counts()
        (x0, y0), (x1, y1) = (w * 0.21, h * 0.19), (w * 0.73, h * 0.74)
        for kind, x, y in (("start", x0, y0), ("move", x1, y1), ("end", x1, y1)):
            ok("/event", {"type": f"action_{kind}", "x": x, "y": y})
        assert kernels.LAUNCHES == _only(geometry=1)
        assert 0 < int(m.buffers.selection.sum()) < g.count
        ok("/command", {"cmd": "commit_edit"})
        ply = call("/export", {"choices": {"scene.ply": {"with_mask": True}}})
        assert read_ply(io.BytesIO(ply)).count == kept

        ok("/set", {"compressions": {"sh": "half"}})
        assert s.compressions.sh.value == "half"
        kernels.reset_launch_counts()
        repacked = call("/frame.jpg?quality=85")
        assert kernels.LAUNCHES == _only(fused=1, sort=1, composite=composite_launches(32),
                                         overlay=1)
        assert repacked[:2] == b"\xff\xd8" and size_of(repacked) == (w, h)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_native_codec_on_card_host_matches_numpy(dev):
    """The native codec builds on the card's host, the default
    `pack_gaussians` runs it, and its pod meets numpy's within
    `tests/test_native.py`'s tolerances: positions equal, colour and norm8
    SH bytes within one step, SH ranges within rtol 1e-6, covariance within
    rtol 1e-3."""
    from wgpu_3dgs_viewer_app_tpu_torch.data import native

    g = make_random_scene(500_000, seed=0, extent=2.0, scale_range=(0.004, 0.02))
    comp = Compressions()
    assert native.available()
    got, ref = pack_gaussians(g, comp), pack_gaussians(g, comp, use_native=False)
    direct = native.pack_gaussians_native(g, comp)
    assert set(got) == set(direct) == set(ref)
    assert all(np.array_equal(got[k], direct[k]) for k in got)
    assert np.array_equal(got["pos"], ref["pos"])
    for k in ("color0", "sh"):   # bytes
        d = got[k].view(np.uint8).astype(np.int16) - ref[k].view(np.uint8)
        assert int(np.abs(d).max()) <= 1, k
    for k in ("sh_mn", "sh_span"):
        assert np.allclose(got[k], ref[k], rtol=1e-6, atol=0), k
    assert np.allclose(got["cov3d"].astype(np.float32), ref["cov3d"].astype(np.float32),
                       rtol=1e-3, atol=1e-6)


# --- the kernels at the main path's shapes: BASELINE configs 1-3 (card.py's scenes) ------

@pytest.fixture(scope="module")
def config1():
    """Config 1 on the card: (comp, pod, cfg, view, proj, count) of the
    6M-splat scene at 1920x1080, tile 32, max_dup 4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g, cam = card.config1_scene()
    comp, pod = card.pod_tensors(g, "cuda")
    return (comp, pod, TileConfig(1920, 1080, tile=32, max_dup=4), cam.view(),
            cam.projection(1920 / 1080), g.count)


def test_frontend_sort_and_composite_at_config1_match_plain(config1):
    """At config 1's shapes: K1 ungated and with every gate slot for slot,
    K2 row for row against the stable plain sort (24M slots), and K3 within
    K67_TOL of its plain version in the Horner and the quadratic-basis form
    (`transposed` False and True equal) and at tiles 64 and 128."""
    comp, pod, cfg, view, proj, n = config1
    args = (pod, comp, cfg, view, proj, EYE)
    ent = enumerate_entries_fused(*args)
    assert compare_entries(ent, enumerate_entries_plain(*args), cfg)["live_a"] > n // 2
    gates = card.gates(n, ent.device)
    gated = enumerate_entries_fused(*args, **gates)
    compare_entries(gated, enumerate_entries_plain(*args, **gates), cfg)
    assert not torch.equal(gated, ent)
    del gated, gates
    se = sort_entries(ent, cfg)
    compare_sorted(se, sort_entries_plain(ent, cfg), stable=True)
    del ent
    for mxu in (False, True):
        got = composite_tiles_v2(se, cfg, transposed=not mxu, mxu=mxu)
        err = float((got - composite_tiles_plain_v2(se, cfg, mxu=mxu)).abs().max())
        assert err <= K67_TOL, (mxu, err)
    assert torch.equal(got, composite_tiles_v2(se, cfg, transposed=True, mxu=True))
    del se
    for tile in (64, 128):
        cfg_t = TileConfig(1920, 1080, tile=tile, max_dup=4)
        se = sort_entries(enumerate_entries_fused(pod, comp, cfg_t, view, proj, EYE), cfg_t)
        err = float((composite_tiles_v2(se, cfg_t) - composite_tiles_plain_v2(se, cfg_t))
                    .abs().max())
        assert err <= K67_TOL, (tile, err)


def test_staged_and_v1_routes_at_config1_match_plain(config1):
    """At config 1's shapes: K8 bit for bit the plain preprocess, K5's
    entries from each equal and K5 slot for slot its plain version; the v1
    chain's K2 (at the v1 key) row for row the stable plain sort and K6
    within K67_TOL of its plain version."""
    comp, pod, cfg, view, proj, n = config1
    args = (pod, comp, view, proj, EYE, 1920, 1080)
    pre, pre_p = preprocess_fused(*args), preprocess(*args)
    assert compare_preprocess_bits(pre, pre_p)["valid"] > n // 2
    ent = enumerate_entries_from_pre(pre, cfg)
    assert torch.equal(ent, enumerate_entries_from_pre(pre_p, cfg))
    del pre_p
    compare_entries(ent, enumerate_entries_from_pre_plain(pre, cfg), cfg)
    del ent
    slots = tile_list_entries(pre, cfg)
    compare_sorted(sort_entries(slots, cfg, shift=cfg.depth_bits),
                   sort_entries_plain(slots, cfg, shift=cfg.depth_bits), stable=True)
    del slots
    planes = build_entry_planes(pre, build_tile_lists(pre, cfg), cfg)
    err = float((composite_tiles(planes, cfg) - composite_tiles_plain(planes, cfg)).abs().max())
    assert err <= K67_TOL, err


def test_geometry_and_gated_kernels_at_config3_match_plain(dev):
    """At config 3's shapes (2M splats): K4 ungated and gated (mask, edits)
    against its plain version; with the step's gates (its rect selection on
    K4's geometry, selection edit and highlight, a mask and edits) K8 bit
    for bit the plain preprocess, K5's entries from each equal, and K1 slot
    for slot its plain version."""
    g, cam = card.config3_scene()
    comp, pod = card.pod_tensors(g, dev)
    cfg = TileConfig(1920, 1080, tile=32, max_dup=4)
    view, proj = cam.view(), cam.projection(1920 / 1080)
    args = (pod, comp, view, proj, EYE, 1920, 1080)
    gates = card.gates(g.count, dev, seed=5)
    gates = {k: gates[k] for k in ("mask_bits", "edit")}
    for kw in ({}, gates):
        compare_preprocess(preprocess_geometry_fused(*args, **kw),
                           preprocess_geometry_plain(*args, **kw))
    sel_edit, highlight = card.selection_pods()
    gates.update(selection_bits=select_rect(preprocess_geometry_fused(*args), *card.CONFIG3_RECT),
                 selection_edit=sel_edit.as_arrays(), highlight_rgba=np.float32(highlight.rgba))
    pre, pre_p = preprocess_fused(*args, **gates), preprocess(*args, **gates)
    compare_preprocess_bits(pre, pre_p)
    assert not torch.equal(pre.col_r, preprocess_fused(*args).col_r)
    assert torch.equal(enumerate_entries_from_pre(pre, cfg),
                       enumerate_entries_from_pre(pre_p, cfg))
    del pre, pre_p
    compare_entries(enumerate_entries_fused(pod, comp, cfg, view, proj, EYE, **gates),
                    enumerate_entries_plain(pod, comp, cfg, view, proj, EYE, **gates), cfg)


def test_ranked_kernels_at_config2_match_plain(dev):
    """One config-2 model (1M splats, its transform and edits, 1920x1088,
    model_bits 2): K8 bit for bit the plain preprocess, K5's entries from
    each equal; K5 at ranks 0 and 2 and K1 at rank 1 slot for slot their
    plain versions, every live key carrying its rank."""
    comp, pod, cfg, view, proj, mmat, edit = card.config2_model(1, dev)
    args = (pod, comp, view, proj, mmat, *card.CONFIG2_SIZE)
    pre, pre_p = preprocess_fused(*args, edit=edit), preprocess(*args, edit=edit)
    compare_preprocess_bits(pre, pre_p)
    assert torch.equal(enumerate_entries_from_pre(pre, cfg, model_rank=2),
                       enumerate_entries_from_pre(pre_p, cfg, model_rank=2))
    del pre_p
    k5 = (enumerate_entries_from_pre, enumerate_entries_from_pre_plain, (pre, cfg), {})
    k1 = (enumerate_entries_fused, enumerate_entries_plain, (pod, comp, cfg, view, proj, mmat),
          {"edit": edit})
    for rank, (kernel, plain, a, kw) in ((0, k5), (2, k5), (1, k1)):
        got = kernel(*a, model_rank=rank, **kw)
        compare_entries(got, plain(*a, model_rank=rank, **kw), cfg)
        keys = got[:, 0].to(torch.int64) & 0xFFFFFFFF
        assert bool(((keys[keys != SENTINEL] >> cfg._rank_shift) & 3 == rank).all()), rank
