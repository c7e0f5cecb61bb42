"""The viewer's fused frame on a card, issued as one replayed CUDA graph.

A frame of `MultiModelViewer.render` on the fused route is K1 for each
visible model, K2, K3's two passes and the background blend. Issued launch
by launch, that is some thirty host calls a frame. Here the frame is
captured once as a CUDA graph and each later frame replays it. Per frame,
the host:
1. writes the frame's parameter block into pinned memory: one K1
   `FrameRecord` a model (`ops/fused.py::write_frame_record`), holding the
   camera, the model's matrix and rank, the selection edit and the
   highlight;
2. launches the graph, whose first node copies the block to the device;
3. copies the image out of the frame buffers.
No step waits for the device: K2 keeps its live count on the device and the
background is a device tensor.

A captured launch keeps its arguments. So everything the launches fix is
the graph's key: the tiling and key layout, the compressions, the display
transform's SH degree and mode, each visible model's pod and gate tensors
(their addresses), its gate code, its row range in the entry buffer, and
whether spans record (K3's counter). What a frame may change rides the
block. Everything a frame writes lies in one `FrameBuffers` per viewer and
frame shape, which all of the viewer's graphs share. A key is captured the
second frame in a row that it is seen; until then, and for a key seen once,
the frame runs eager through the same launchers, buffers and block. A few
graphs are kept, the least recently used dropped first.
"""

from __future__ import annotations

import collections

import torch

from ..core.transform import GaussianDisplayMode
from ..ops import kernels
from ..ops.binning import TileConfig
from ..ops.composite import composite_buffers, composite_tiles_v2, over_background
from ..ops.fused import (RECORD_WORDS, _cuda_gates, enumerate_entries_fused, frame_base,
                         write_frame_record)
from ..ops.sort import sort_buffers, sort_entries
from ..utils import trace

# Graphs kept per viewer.
CACHE = 4
# The kernel launchers whose launches a replay adds to `LAUNCHES`.
_COUNTED = ("fused", "sort", "composite")


class FrameBuffers:
    """What a fused frame writes, allocated once per viewer and frame shape:
    the entry buffer (`rows` slots, every model's capacity times max_dup),
    K2's and K3's buffers, the image over the background (and the blend's
    scratch), and the parameter block, `slots` records in pinned memory and
    on the device. `copied` is recorded right after each frame's copy of
    the block (an event record node of the graphs), so the host writes the
    pinned block only once the last frame has read it."""

    def __init__(self, cfg: TileConfig, rows: int, slots: int, device):
        self.shape = (cfg.width, cfg.height, cfg.tile, cfg.max_dup, rows, slots)
        self.entries = torch.empty((rows, 4), dtype=torch.int32, device=device)
        self.sort = sort_buffers(rows, cfg.n_tiles, device)
        self.composite = composite_buffers(cfg, device)
        self.image = torch.empty((cfg.height, cfg.width, 3), dtype=torch.float32, device=device)
        self.alpha = torch.empty((cfg.height, cfg.width, 1), dtype=torch.float32, device=device)
        self.block_host = torch.zeros((slots, RECORD_WORDS), dtype=torch.int32,
                                      pin_memory=torch.device(device).type == "cuda")
        self.block = torch.zeros((slots, RECORD_WORDS), dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()
        self.copied.record()  # made now: the frames record it by its handle


class FrameGraphs:
    """The fused frame of one `MultiModelViewer` on a card: its frame
    buffers, its captured graphs by key, and the key of its last frame."""

    def __init__(self, viewer):
        self.viewer = viewer
        self.bufs: FrameBuffers | None = None
        self.graphs: collections.OrderedDict = collections.OrderedDict()
        self.last_key = None
        self.stream = torch.cuda.Stream(viewer.device)

    def _buffers(self) -> FrameBuffers:
        v = self.viewer
        rows = sum(m.buffers.capacity for m in v.models.values()) * v.cfg.max_dup
        shape = (v.cfg.width, v.cfg.height, v.cfg.tile, v.cfg.max_dup, rows, len(v.models))
        if self.bufs is None or self.bufs.shape != shape:
            # The graphs write the old buffers: they go with them.
            self.graphs.clear()
            self.last_key = None
            self.bufs = None  # freed before the new ones are made
            self.bufs = FrameBuffers(v.cfg, rows, len(v.models), v.device)
        return self.bufs

    def render(self, order: list, show_unedited: bool) -> torch.Tensor:
        """The frame of the visible models in `order` (back to front) ->
        (H, W, 3) f32 over the background, a new tensor."""
        v = self.viewer
        n = len(order)
        with trace.span("viewer.prologue"):
            cfg = v.cfg if n == 1 else v.merged_config(n)
            bufs = self._buffers()
            rank = {k: n - 1 - i for i, k in enumerate(order)}
            # Fixed row ranges: the visible models in insertion order. Equal
            # keys carry one rank, so the sort's order does not depend on it.
            slots = [k for k in v.models if k in rank]
            gt = v.gaussian_transform
            if not bufs.copied.query():
                # The last frame's copy of the block has not run yet.
                with trace.host_read():
                    bufs.copied.synchronize()
            base = frame_base(v._view, v._proj, cfg, gt.size)
            flat = gt.display_mode != GaussianDisplayMode.SPLAT
            handed = trace.k3_handed(bufs.entries.device)
        plan, slot_keys, start = [], [], 0
        block = bufs.block_host.numpy()
        for i, k in enumerate(slots):
            with trace.span("k1.frontend"):
                m = v.models[k]
                b = m.buffers
                gates = v._gating_kwargs(m, show_unedited)
                code, sel_flags, consts, tensors = _cuda_gates(b.capacity, v.device, check=False,
                                                               **gates)
                write_frame_record(block[i], base, m.model_matrix(), rank[k], cfg, consts,
                                   sel_flags)
                rows = b.capacity * cfg.max_dup
                plan.append((m, rank[k], gates, start, start + rows))
                slot_keys.append((b.capacity, tuple(t.data_ptr() for t in b.pod.values()), code,
                                  tuple(kernels.ptr(t) for t in tensors)))
                start += rows
        key = (cfg, v.comp, gt.sh_deg.degree, gt.no_sh0, int(gt.display_mode),
               kernels.ptr(handed), tuple(slot_keys))

        def issue():
            self._issue(bufs, cfg, plan, start, flat)

        graph = self.graphs.get(key)
        if graph is None and key == self.last_key:
            graph = self._capture(key, issue)
            kind = "captured"
        else:
            kind = "replayed" if graph is not None else "eager"
        self.last_key = key
        trace.count_frame(kind)
        if graph is None:
            issue()
            return bufs.image.clone()
        with trace.span("viewer.replay"):
            self.graphs.move_to_end(key)
            graph[0].replay()
            for name, count in graph[1].items():
                kernels.LAUNCHES[name] += count
            return bufs.image.clone()

    def _issue(self, bufs: FrameBuffers, cfg: TileConfig, plan: list, rows: int,
               flat: bool) -> None:
        """The frame on the current stream: the block's copy, then its
        launches."""
        self._upload(bufs)
        self._launch(bufs, cfg, plan, rows, flat)

    @staticmethod
    def _upload(bufs: FrameBuffers) -> None:
        """The parameter block from pinned memory to the device, and the
        event that tells the host the pinned block may be written again."""
        lib = kernels.library()
        stream = kernels.stream()
        kernels.check(lib.gs_copy_async(bufs.block.data_ptr(), bufs.block_host.data_ptr(),
                                        bufs.block.numel() * 4, stream), "gs_copy_async")
        kernels.check(lib.gs_record_event(bufs.copied.cuda_event, stream), "gs_record_event")

    def _launch(self, bufs: FrameBuffers, cfg: TileConfig, plan: list, rows: int,
                flat: bool) -> None:
        """K1 a model into its rows, K2, K3 and the blend into the buffers."""
        v = self.viewer
        gt = v.gaussian_transform
        for i, (m, rank, gates, r0, r1) in enumerate(plan):
            with trace.span("k1.frontend"):
                enumerate_entries_fused(m.buffers.pod, v.comp, cfg, v._view, v._proj,
                                        m.model_matrix(),
                                        sh_degree=gt.sh_deg.degree, no_sh0=gt.no_sh0,
                                        size=gt.size, display_mode=int(gt.display_mode),
                                        model_rank=rank, out=bufs.entries[r0:r1],
                                        record=bufs.block[i], **gates)
        with trace.span("k2.sort"):
            se = sort_entries(bufs.entries[:rows], cfg, bufs=bufs.sort)
        with trace.span("k3.composite"):
            img = composite_tiles_v2(se, cfg, flat_mode=flat, bufs=bufs.composite)
        over_background(img, v.background_tensor, out=bufs.image, scratch=bufs.alpha)

    def _capture(self, key, issue) -> tuple:
        """Capture `issue` as a CUDA graph on the viewer's side stream and
        keep it under `key` -> (graph, the launches it makes a replay). The
        launchers count their launches as they are captured; a capture
        launches nothing, so the count is taken back and added at each
        replay."""
        before = {name: kernels.LAUNCHES[name] for name in _COUNTED}
        graph = torch.cuda.CUDAGraph()
        self.stream.wait_stream(torch.cuda.current_stream(self.viewer.device))
        with torch.cuda.stream(self.stream):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                issue()
            finally:
                graph.capture_end()
        launched = {name: kernels.LAUNCHES[name] - before[name] for name in _COUNTED}
        for name in _COUNTED:
            kernels.LAUNCHES[name] = before[name]
        self.graphs[key] = (graph, launched)
        while len(self.graphs) > CACHE:
            self.graphs.popitem(last=False)
        return self.graphs[key]
