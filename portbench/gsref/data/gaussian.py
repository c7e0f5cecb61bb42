"""Gaussian data model: the Inria PLY record and a struct-of-arrays container.

Host-side numpy, identical to `wgpu_3dgs_viewer_app_tpu.data.gaussian`:
the 62-f32 (248 B) Inria splat record and the SoA `Gaussians` holding raw
PLY-space values (log scale, logit opacity, unnormalised quaternions), so
export round-trips losslessly.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# The Inria 3DGS PLY vertex properties, in file order.
PLY_PROPERTIES = (
    ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    + [f"f_rest_{i}" for i in range(45)]
    + ["opacity", "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2", "rot_3"]
)

PLY_GAUSSIAN_POD_DTYPE = np.dtype([(p, "<f4") for p in PLY_PROPERTIES])
PLY_GAUSSIAN_POD_SIZE = PLY_GAUSSIAN_POD_DTYPE.itemsize  # 248


def sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


def inverse_sigmoid(y: np.ndarray) -> np.ndarray:
    y = np.clip(y, 1e-6, 1.0 - 1e-6)
    return np.log(y / (1.0 - y))


@dataclasses.dataclass
class Gaussians:
    """SoA splat container.

    Fields:
      pos      (N, 3) f32
      normal   (N, 3) f32   (unused by rendering; preserved for round-trip)
      sh0      (N, 3) f32   f_dc
      sh_rest  (N, 15, 3) f32  f_rest reordered to [coeff, channel]
      opacity  (N,)   f32   pre-sigmoid
      scale    (N, 3) f32   log-scale
      rot      (N, 4) f32   quaternion (w, x, y, z), unnormalised
    """

    pos: np.ndarray
    normal: np.ndarray
    sh0: np.ndarray
    sh_rest: np.ndarray
    opacity: np.ndarray
    scale: np.ndarray
    rot: np.ndarray

    def __len__(self) -> int:
        return self.pos.shape[0]

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    def original_size(self) -> int:
        """Raw PLY byte size (one 248-byte record per splat)."""
        return self.count * PLY_GAUSSIAN_POD_SIZE

    @staticmethod
    def empty(n: int = 0) -> "Gaussians":
        return Gaussians(
            pos=np.zeros((n, 3), np.float32),
            normal=np.zeros((n, 3), np.float32),
            sh0=np.zeros((n, 3), np.float32),
            sh_rest=np.zeros((n, 15, 3), np.float32),
            opacity=np.zeros(n, np.float32),
            scale=np.zeros((n, 3), np.float32),
            rot=np.concatenate(
                [np.ones((n, 1), np.float32), np.zeros((n, 3), np.float32)], axis=1
            ),
        )

    @staticmethod
    def from_pod_records(records: np.ndarray) -> "Gaussians":
        """Structured `PLY_GAUSSIAN_POD_DTYPE` records -> SoA."""
        flat = records.view("<f4").reshape(len(records), 62)
        # f_rest is channel-major in the PLY: [R x15, G x15, B x15].
        sh_rest = np.ascontiguousarray(flat[:, 9:54].reshape(-1, 3, 15).transpose(0, 2, 1))
        return Gaussians(
            pos=flat[:, 0:3].copy(),
            normal=flat[:, 3:6].copy(),
            sh0=flat[:, 6:9].copy(),
            sh_rest=sh_rest,
            opacity=flat[:, 54].copy(),
            scale=flat[:, 55:58].copy(),
            rot=flat[:, 58:62].copy(),
        )

    def to_pod_records(self) -> np.ndarray:
        """SoA -> structured `PLY_GAUSSIAN_POD_DTYPE` records."""
        n = self.count
        flat = np.empty((n, 62), np.float32)
        flat[:, 0:3] = self.pos
        flat[:, 3:6] = self.normal
        flat[:, 6:9] = self.sh0
        flat[:, 9:54] = self.sh_rest.transpose(0, 2, 1).reshape(n, 45)
        flat[:, 54] = self.opacity
        flat[:, 55:58] = self.scale
        flat[:, 58:62] = self.rot
        return np.ascontiguousarray(flat).view(PLY_GAUSSIAN_POD_DTYPE).reshape(n)

    def _map(self, fn) -> "Gaussians":
        return Gaussians(*(fn(getattr(self, f.name)) for f in dataclasses.fields(self)))

    def slice(self, start: int, stop: int) -> "Gaussians":
        return self._map(lambda a: a[start:stop])

    def select(self, mask: np.ndarray) -> "Gaussians":
        return self._map(lambda a: a[mask])

    @staticmethod
    def concat(parts: list) -> "Gaussians":
        names = [f.name for f in dataclasses.fields(Gaussians)]
        return Gaussians(*(np.concatenate([getattr(p, k) for p in parts]) for k in names))

    def center(self) -> np.ndarray:
        """Mean splat position (the model centre used for model ordering)."""
        if self.count == 0:
            return np.zeros(3, np.float32)
        return self.pos.mean(axis=0).astype(np.float32)
