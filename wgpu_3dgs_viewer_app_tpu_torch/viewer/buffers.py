"""Per-model device buffers: the flat word pod and its per-splat sidecars at
a fixed capacity.

Counterpart of `wgpu_3dgs_viewer_app_tpu.viewer.buffers.GaussianBuffers`.
Everything lives on `device`:
- the pod fields (data/compression.py), allocated once with every slot
  empty (alpha 0, never rendered); `update_range` compresses a chunk on the
  host and writes it IN PLACE, so a streamed chunk costs O(chunk), not
  O(capacity);
- the per-splat edit SoA: `edit_flags` (N,) int32 (u32 bit patterns),
  `edit_rgb` (N, 3) f32, `edit_params` (N, 4) f32;
- `selection` (N,) uint8 and `mask` (N,) uint8, in the layout the
  front-end kernels read directly.
Each of these is None until it is first set (or, for the edits, committed):
the viewer passes only the gates that exist, so a scene never edited holds
no gate memory and renders through the ungated front-end. The downloads
give the defaults for a gate never set: identity edits, selection 0,
mask 1.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.edit import make_edit_soa
from ..core.f16 import as_i32, u32
from ..data.compression import Compressions, flat_pod_to_words, pack_gaussians, pod_to_tensors
from ..data.gaussian import Gaussians
from ..utils import trace


def _flags_tensor(flags, device) -> torch.Tensor:
    """u32 flags (numpy or tensor) -> int32 bit patterns on `device`."""
    if not torch.is_tensor(flags):
        flags = torch.from_numpy(np.ascontiguousarray(flags, np.uint32).view(np.int32))
    elif flags.dtype != torch.int32:
        flags = as_i32(u32(flags))
    return flags.to(device).contiguous()


class GaussianBuffers:
    """Device-resident splat state for one model, with fixed capacity."""

    def __init__(self, capacity: int, comp: Compressions, device="cuda"):
        self.capacity = max(int(capacity), 1)
        self.comp = comp
        self.device = torch.device(device)
        self.loaded = 0
        n = self.capacity
        empty = flat_pod_to_words(pack_gaussians(Gaussians.empty(1), comp), comp)
        self.pod = {
            k: torch.zeros(v.shape[:-1] + (n,), dtype=v.dtype, device=self.device)
            for k, v in pod_to_tensors(empty, "cpu").items()
        }
        self.edit_flags = self.edit_rgb = self.edit_params = None
        self.selection: torch.Tensor | None = None
        self.mask: torch.Tensor | None = None

    def __len__(self) -> int:
        return self.loaded

    def update_range(self, start: int, chunk: Gaussians) -> None:
        """Compress `chunk` and write it in place at splats [start, start + n)."""
        n = chunk.count
        if start < 0 or start + n > self.capacity:
            raise ValueError(f"range [{start}, {start + n}) exceeds capacity {self.capacity}")
        words = flat_pod_to_words(pack_gaussians(chunk, self.comp), self.comp)
        words = pod_to_tensors(words, "cpu")
        for k, v in words.items():
            dst = self.pod[k][..., start:start + n]
            # From pageable memory: on a card each copy waits for the stream.
            with trace.host_read(dst.is_cuda):
                dst.copy_(v)
        self.loaded = max(self.loaded, start + n)

    def upload_all(self, g: Gaussians) -> None:
        self.update_range(0, g)
        self.loaded = g.count

    # --- edit / selection / mask state ----------------------------------------

    def _bits(self, bits, fill: int, into: torch.Tensor | None) -> torch.Tensor:
        """(n <= capacity,) bits -> (capacity,) uint8 on the device, the
        tail filled with `fill`; written into `into` where given."""
        bits = torch.as_tensor(bits, device=self.device)
        if into is None:
            into = torch.empty((self.capacity,), dtype=torch.uint8, device=self.device)
        n = bits.shape[0]
        into[:n] = bits != 0
        into[n:] = fill
        return into

    # The setters write into the tensor a gate already has: its address is
    # part of what a captured frame graph reads (viewer/graph.py), so a mask
    # drag or a selection changes no address and needs no new capture.

    def set_selection(self, bits) -> None:
        self.selection = self._bits(bits, 0, self.selection)

    def set_mask(self, bits) -> None:
        self.mask = self._bits(bits, 1, self.mask)

    def set_edits(self, flags, rgb, params) -> None:
        """The whole per-splat edit SoA, (capacity,) / (capacity, 3) /
        (capacity, 4)."""
        new = (_flags_tensor(flags, self.device),
               torch.as_tensor(rgb, dtype=torch.float32, device=self.device).contiguous(),
               torch.as_tensor(params, dtype=torch.float32, device=self.device).contiguous())
        old = (self.edit_flags, self.edit_rgb, self.edit_params)
        if old[0] is not None and all(o.shape == t.shape for o, t in zip(old, new)):
            for o, t in zip(old, new):
                o.copy_(t)
        else:
            self.edit_flags, self.edit_rgb, self.edit_params = new

    def commit_selection_edit(self, pod_flags: int, rgb, params) -> None:
        """Bake the scene-wide selection edit into the per-splat edit records
        of the selected splats (identity records where no edit was set)."""
        if self.edit_flags is None:
            self.set_edits(*make_edit_soa(self.capacity))
        if self.selection is None:
            return
        sel = self.selection != 0
        rgb = torch.as_tensor(np.asarray(rgb, np.float32), device=self.device)
        params = torch.as_tensor(np.asarray(params, np.float32), device=self.device)
        self.edit_flags = torch.where(sel, int(np.uint32(pod_flags).view(np.int32)),
                                      self.edit_flags)
        self.edit_rgb = torch.where(sel[:, None], rgb, self.edit_rgb)
        self.edit_params = torch.where(sel[:, None], params, self.edit_params)

    def adopt_edit_state(self, other: "GaussianBuffers") -> None:
        """Take over another buffer's edit SoA, selection and mask (same
        capacity and device; None stays None)."""
        if other.capacity != self.capacity or other.device != self.device:
            raise ValueError("edit state moves only between buffers of one capacity and device")
        self.edit_flags, self.edit_rgb, self.edit_params = (other.edit_flags, other.edit_rgb,
                                                            other.edit_params)
        self.selection, self.mask = other.selection, other.mask

    # --- downloads (device -> host, for export and queries) -------------------

    def download_edits(self):
        """(flags u32 (n,), rgb f32 (n, 3), params f32 (n, 4)) of the loaded
        splats."""
        n = self.loaded
        if self.edit_flags is None:
            return make_edit_soa(n)
        return (self.edit_flags[:n].cpu().numpy().view(np.uint32),
                self.edit_rgb[:n].cpu().numpy(), self.edit_params[:n].cpu().numpy())

    def download_mask(self) -> np.ndarray:
        if self.mask is None:
            return np.ones(self.loaded, np.uint8)
        return self.mask[: self.loaded].cpu().numpy()

    def download_selection(self) -> np.ndarray:
        if self.selection is None:
            return np.zeros(self.loaded, np.uint8)
        return self.selection[: self.loaded].cpu().numpy()

    def compressed_size(self) -> int:
        """Bytes of the packed splats at the buffers' compression and capacity."""
        return self.comp.compressed_size(self.capacity)
