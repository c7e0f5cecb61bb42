"""Per-model device buffers: the flat word pod at a fixed capacity.

Counterpart of `wgpu_3dgs_viewer_app_tpu.viewer.buffers.GaussianBuffers`
for ungated frames. The pod fields (data/compression.py) are allocated once
on `device` with every slot empty (alpha 0, never rendered);
`update_range` compresses a chunk on the host and writes it IN PLACE into
the device tensors, so a streamed chunk costs O(chunk), not O(capacity).
Edit, selection and mask buffers wait for the gated front-end (ROADMAP).
"""

from __future__ import annotations

import torch

from ..data.compression import Compressions, flat_pod_to_words, pack_gaussians, pod_to_tensors
from ..data.gaussian import Gaussians


class GaussianBuffers:
    """Device-resident splat state for one model, with fixed capacity."""

    def __init__(self, capacity: int, comp: Compressions, device="cuda"):
        self.capacity = max(int(capacity), 1)
        self.comp = comp
        self.device = torch.device(device)
        self.loaded = 0
        empty = flat_pod_to_words(pack_gaussians(Gaussians.empty(1), comp), comp)
        self.pod = {
            k: torch.zeros(v.shape[:-1] + (self.capacity,), dtype=v.dtype, device=self.device)
            for k, v in pod_to_tensors(empty, "cpu").items()
        }

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
            self.pod[k][..., start:start + n].copy_(v)
        self.loaded = max(self.loaded, start + n)

    def upload_all(self, g: Gaussians) -> None:
        self.update_range(0, g)
        self.loaded = g.count
