"""The viewer's frame graph (`viewer/graph.py`) on the CPU: K1's frame record
(`ops/fused.py::write_frame_record`) equals the frame scalars and int
parameters the launchers packed before, bit for bit, over random cameras,
transforms, gates and ranks; the graph's key logic through stand-ins for
the CUDA runtime and the kernel wrappers (eager on a new key, captured on
its second frame in a row, replayed after; a new gate tensor makes a new
key, a change of the models' order does not; a replay counts its launches);
and the gate setters, which write in place. Imports no JAX."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

import _torch_cpu  # noqa: F401  (one torch thread per test process)
from wgpu_3dgs_viewer_app_tpu_torch.core import CameraOrbitControl, ModelTransform
from wgpu_3dgs_viewer_app_tpu_torch.core.edit import GaussianEditPod, SelectionHighlightPod
from wgpu_3dgs_viewer_app_tpu_torch.data import Compressions, make_random_scene
from wgpu_3dgs_viewer_app_tpu_torch.data.compression import Cov3dCompression, ShCompression
from wgpu_3dgs_viewer_app_tpu_torch.ops import kernels
from wgpu_3dgs_viewer_app_tpu_torch.ops import fused
from wgpu_3dgs_viewer_app_tpu_torch.ops.binning import SortedEntries, TileConfig
from wgpu_3dgs_viewer_app_tpu_torch.ops.preprocess import frame_scalars
from wgpu_3dgs_viewer_app_tpu_torch.utils import trace
from wgpu_3dgs_viewer_app_tpu_torch.viewer import MultiModelViewer, graph
from wgpu_3dgs_viewer_app_tpu_torch.viewer.buffers import GaussianBuffers

W, H = 64, 48
_SEL_FLAGS, _RANK = 12, 14  # in `_int_param_array`


def _camera(rng) -> CameraOrbitControl:
    pos = rng.normal(size=3) * 2.0
    pos[2] -= 4.0
    return CameraOrbitControl(target=tuple(rng.normal(size=3) * 0.2), pos=tuple(pos))


def _transform(rng) -> ModelTransform:
    return ModelTransform(pos=rng.normal(size=3).astype(np.float32),
                          rot=rng.uniform(-180, 180, 3).astype(np.float32),
                          scale=rng.uniform(0.5, 2.0, 3).astype(np.float32))


@pytest.mark.parametrize("seed", range(6))
def test_frame_record_equals_param_arrays(seed):
    """A model's FrameRecord, the frame's shared floats with the model's
    rows written over them, equals `_frame_param_array` of the model's own
    frame scalars and `_int_param_array`'s selection flags and rank, bit for
    bit, over random cameras, transforms, sizes, gates and ranks."""
    rng = np.random.default_rng(seed)
    cfg = TileConfig(W + seed, H, tile=16, max_dup=4, model_bits=int(rng.integers(0, 4)))
    cam = _camera(rng)
    view = np.asarray(cam.view(), np.float32)
    proj = np.asarray(cam.projection(cfg.width / cfg.height), np.float32)
    size = float(rng.uniform(0.2, 2.0))
    base = fused.frame_base(view, proj, cfg, size)
    n = 10
    row = np.zeros(fused.RECORD_WORDS, np.int32)
    for _ in range(4):
        model = _transform(rng).matrix()
        rank = int(rng.integers(0, 1 << cfg.model_bits))
        gates = {}
        if rng.random() < 0.7:
            gates["selection_bits"] = torch.ones(n, dtype=torch.uint8)
            gates["selection_edit"] = (np.array([rng.integers(0, 1 << 32)], np.uint64),
                                       rng.random(3).astype(np.float32),
                                       rng.normal(size=4).astype(np.float32))
            if rng.random() < 0.5:
                gates["highlight_rgba"] = rng.random(4).astype(np.float32)
        code, sel_flags, consts, _ = fused._cuda_gates(n, "cpu", check=False, **gates)
        fused.write_frame_record(row, base, model, rank, cfg, consts, sel_flags)
        fs = frame_scalars(view, proj, model, cfg.width, cfg.height, size)
        want = np.array(fused._frame_param_array(fs, cfg, consts), np.float32)
        assert np.array_equal(row[:55], want.view(np.int32))
        ints = fused._int_param_array(n, Compressions(), 0, code, 3, False, cfg, sel_flags, rank)
        assert (row[55], row[56]) == (ints[_SEL_FLAGS], ints[_RANK])
        assert not row[57:].any()


# --- the key logic, through stand-ins --------------------------------------------


class _Graph:
    """Stands in for torch.cuda.CUDAGraph: counts captures and replays."""

    def __init__(self):
        self.replays = 0

    def capture_begin(self, capture_error_mode="global"):
        assert capture_error_mode == "thread_local"
        _Runtime.capturing = True

    def capture_end(self):
        _Runtime.capturing = False

    def replay(self):
        self.replays += 1


class _Event:
    cuda_event = 0

    def query(self):
        return True

    def record(self):
        pass

    def synchronize(self):
        raise AssertionError("no frame waits for the last one here")


class _Stream:
    def wait_stream(self, other):
        pass


class _Runtime:
    """Stands in for the kernel library (`gs_copy_async` copies host
    memory) and the frame's three kernel wrappers, which record what they
    are handed and count their launches as the real ones do."""

    capturing = False

    def __init__(self):
        self.k1, self.copies = [], 0

    @staticmethod
    def gs_sort_meta_words():
        return 2 * 4 * 256 + 1

    @staticmethod
    def gs_sort_num_tiles(n):
        return -(-n // 2560)

    def gs_copy_async(self, dst, src, nbytes, stream):
        ctypes.memmove(dst, src, nbytes)
        self.copies += 1
        return 0

    def gs_record_event(self, event, stream):
        assert self.copies
        return 0

    def enumerate_entries_fused(self, pod, comp, cfg, view, proj, model, model_rank=0, out=None,
                                record=None, **kw):
        self.k1.append((record.clone(), out.data_ptr(), out.shape[0], model_rank, self.capturing))
        kernels.LAUNCHES["fused"] += 1
        return out

    def sort_entries(self, entries, cfg, bufs=None):
        kernels.LAUNCHES["sort"] += 1
        return SortedEntries(bufs["a"][:entries.shape[0]], bufs["edges"][:-1], bufs["counts"], 0)

    def composite_tiles_v2(self, se, cfg, flat_mode=False, bufs=None):
        kernels.LAUNCHES["composite"] += 2
        return bufs["out"].zero_()


@pytest.fixture
def runtime(monkeypatch):
    rt = _Runtime()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(kernels, "library", lambda: rt)
    monkeypatch.setattr(kernels, "stream", lambda: 0)
    for name in ("enumerate_entries_fused", "sort_entries", "composite_tiles_v2"):
        monkeypatch.setattr(graph, name, getattr(rt, name))
    before = dict(kernels.LAUNCHES)
    trace.reset()
    yield rt
    kernels.LAUNCHES.update(before)
    trace.reset()


def _viewer(n_models: int) -> MultiModelViewer:
    v = MultiModelViewer(W, H, device="cpu", background=(0.1, 0.2, 0.3))
    for i in range(n_models):
        v.add_model(f"m{i}", make_random_scene(300 + 50 * i, seed=i, extent=0.5,
                                               scale_range=(0.01, 0.03)))
        v.update_model_transform(f"m{i}", ModelTransform(pos=np.array([2.0 * i - 2.0, 0, 0],
                                                                      np.float32)))
    return v


def _frame(v, fg, cam, show_unedited=False):
    """One frame through the graph path -> (how it was issued, launches)."""
    before_launches = dict(kernels.LAUNCHES)
    before = dict(trace.graph_frames)
    with trace.collect():
        v.update_camera(cam)
        fg.render(v.model_order(), show_unedited)
    kind = next(k for k in trace.graph_frames if trace.graph_frames[k] != before[k])
    return kind, {k: kernels.LAUNCHES[k] - before_launches[k] for k in ("fused", "sort",
                                                                        "composite")}


def test_frame_graph_is_captured_on_its_second_frame_and_replayed(runtime):
    """A new key runs eager, its second frame in a row is captured (and
    launched), later frames replay it; every frame counts one launch of each
    model's K1, K2 and K3's two passes, a replay through the graph's count."""
    v = _viewer(1)
    fg = graph.FrameGraphs(v)
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.3, 0.2, -3.0))
    kinds = [_frame(v, fg, cam) for _ in range(4)]
    assert [k for k, _ in kinds] == ["eager", "captured", "replayed", "replayed"]
    assert all(n == {"fused": 1, "sort": 1, "composite": 2} for _, n in kinds)
    assert [c[4] for c in runtime.k1] == [False, True]   # eager, then the capture
    assert runtime.copies == 2
    assert len(fg.graphs) == 1 and next(iter(fg.graphs.values()))[0].replays == 3


def test_frame_graph_keys_on_pointers_not_on_the_order(runtime):
    """The models' order changes along an orbit and rides the block (each
    slot's rank word), so the graph is replayed; a gate tensor set for the
    first time makes a new key, set again in place it does not; a new pod
    (another compression) makes a new key."""
    v = _viewer(3)
    fg = graph.FrameGraphs(v)
    kinds, orders = [], []
    for yaw in np.linspace(0.0, 2.0 * np.pi, 9):
        cam = CameraOrbitControl(target=(0, 0, 0), pos=(7 * np.sin(yaw), 1.0, 7 * np.cos(yaw)))
        kinds.append(_frame(v, fg, cam)[0])
        order = v.model_order()
        orders.append(tuple(order))
        ranks = fg.bufs.block_host[:3, 56].tolist()
        assert ranks == [2 - order.index(k) for k in v.models]
    assert len(set(orders)) > 1
    assert kinds == ["eager", "captured"] + ["replayed"] * 7
    cam = CameraOrbitControl(target=(0, 0, 0), pos=(0.5, 1.0, -7.0))
    m = v.models["m1"]
    m.buffers.set_mask(np.ones(m.buffers.capacity, np.uint8))
    assert [_frame(v, fg, cam)[0] for _ in range(3)] == ["eager", "captured", "replayed"]
    ptr = m.buffers.mask.data_ptr()
    m.buffers.set_mask(np.arange(m.buffers.capacity) % 3 != 0)   # a mask drag
    assert m.buffers.mask.data_ptr() == ptr
    assert _frame(v, fg, cam)[0] == "replayed"
    v.set_compressions(Compressions(sh=ShCompression.HALF, cov3d=Cov3dCompression.SINGLE))
    assert [_frame(v, fg, cam)[0] for _ in range(2)] == ["eager", "captured"]


def test_frame_graph_block_holds_each_frames_scalars(runtime):
    """On replayed frames the pinned block holds, row for row, the frame
    scalars, the scene constants and the ranks that `_frame_param_array`
    and `_int_param_array` give each model of that frame, gated by a
    selection edit and the highlight that change from frame to frame."""
    v = _viewer(2)
    fg = graph.FrameGraphs(v)
    for m in v.models.values():
        m.buffers.set_selection(np.arange(m.buffers.capacity) % 2)
    rng = np.random.default_rng(3)
    for i in range(5):
        v.update_selection_edit(GaussianEditPod(
            flags=int(rng.integers(0, 8)), rgb_or_hsv=tuple(rng.random(3)),
            contrast=float(rng.random()), exposure=float(rng.random()),
            gamma=float(rng.random() + 0.5), alpha=float(rng.random())))
        v.update_selection_highlight(SelectionHighlightPod(rgba=tuple(rng.random(4))), show=True)
        cam = _camera(rng)
        kind, _ = _frame(v, fg, cam)
        assert kind == ["eager", "captured", "replayed", "replayed", "replayed"][i]
        order = v.model_order()
        cfg = v.merged_config(2)
        for slot, (key, m) in enumerate(v.models.items()):
            gates = v._gating_kwargs(m, False)
            code, sel_flags, consts, _ = fused._cuda_gates(m.buffers.capacity, "cpu",
                                                           check=False, **gates)
            fs = frame_scalars(v._view, v._proj, m.transform.matrix(), W, H,
                               v.gaussian_transform.size)
            want = np.array(fused._frame_param_array(fs, cfg, consts), np.float32)
            row = fg.bufs.block_host[slot].numpy()
            assert np.array_equal(row[:55], want.view(np.int32))
            assert code == fused.GATE_SEL_EDIT | fused.GATE_HIGHLIGHT
            assert (row[55], row[56]) == (sel_flags, 1 - order.index(key))


# --- the gate setters ---------------------------------------------------------------


def _old_bits(capacity, bits, fill):
    out = torch.full((capacity,), fill, dtype=torch.uint8)
    bits = torch.as_tensor(bits)
    out[: bits.shape[0]] = bits != 0
    return out


@pytest.mark.parametrize("name,fill", [("set_mask", 1), ("set_selection", 0)])
def test_bit_setters_write_in_place(name, fill):
    """`set_mask` and `set_selection` keep the tensor once it exists and
    write the bits the setters always gave: the given bits as 0/1 and the
    tail past them at the fill."""
    b = GaussianBuffers(40, Compressions(), "cpu")
    rng = np.random.default_rng(5)
    first = rng.integers(0, 3, 40).astype(np.uint8)
    getattr(b, name)(first)
    attr = "mask" if name == "set_mask" else "selection"
    t = getattr(b, attr)
    assert torch.equal(t, _old_bits(40, first, fill))
    for bits in (rng.integers(0, 2, 25), torch.from_numpy(rng.integers(0, 4, 40)), t.clone()):
        getattr(b, name)(bits)
        assert getattr(b, attr) is t and getattr(b, attr).data_ptr() == t.data_ptr()
        assert torch.equal(t, _old_bits(40, bits, fill))
    getattr(b, name)(t)   # the tensor itself
    assert torch.equal(t, _old_bits(40, bits, fill))


def test_set_edits_writes_in_place():
    """`set_edits` keeps the three edit tensors once they exist and writes
    the values given (flags as the u32 bits in int32)."""
    b = GaussianBuffers(30, Compressions(), "cpu")
    rng = np.random.default_rng(6)

    def soa():
        return (rng.integers(0, 1 << 32, 30, dtype=np.uint64).astype(np.uint32),
                rng.random((30, 3)).astype(np.float32), rng.random((30, 4)).astype(np.float32))

    b.set_edits(*soa())
    ptrs = [t.data_ptr() for t in (b.edit_flags, b.edit_rgb, b.edit_params)]
    for _ in range(2):
        flags, rgb, params = soa()
        b.set_edits(flags, rgb, params)
        assert [t.data_ptr() for t in (b.edit_flags, b.edit_rgb, b.edit_params)] == ptrs
        assert np.array_equal(b.edit_flags.numpy().view(np.uint32), flags)
        assert np.array_equal(b.edit_rgb.numpy(), rgb) and np.array_equal(b.edit_params.numpy(),
                                                                          params)
