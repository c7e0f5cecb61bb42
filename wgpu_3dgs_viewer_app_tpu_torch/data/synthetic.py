"""Synthetic splat scenes for tests and benchmarks (host-side numpy).

`make_random_scene` gives the same arrays as the JAX package's generator for
the same seed; the 6M-splat single-model frame uses it with
`extent=2.0, scale_range=(0.004, 0.02)`.
"""

from __future__ import annotations

import numpy as np

from .gaussian import Gaussians, inverse_sigmoid


def make_random_scene(
    n: int,
    seed: int = 0,
    extent: float = 3.0,
    scale_range: tuple = (0.005, 0.05),
    sh_rest_std: float = 0.08,
) -> Gaussians:
    """Random cloud of anisotropic splats inside a cube of +-extent."""
    # SFC64 + float32 draws: PCG64/f64 generation is ~5x slower and
    # dominates set-up at 6M splats.
    rng = np.random.Generator(np.random.SFC64(seed))

    def uni(lo, hi, shape):
        return rng.random(shape, dtype=np.float32) * (hi - lo) + lo

    pos = uni(-extent, extent, (n, 3))
    # Base colours spread over the cube for visual structure.
    sh0 = ((pos / max(extent, 1e-6)) * 0.5
           + rng.standard_normal((n, 3), dtype=np.float32) * 0.15) / np.float32(0.28209479177387814)
    sh_rest = rng.standard_normal((n, 15, 3), dtype=np.float32) * np.float32(sh_rest_std)
    opacity = inverse_sigmoid(uni(0.3, 0.95, (n,))).astype(np.float32)
    scale = np.log(uni(scale_range[0], scale_range[1], (n, 3)))
    rot = rng.standard_normal((n, 4), dtype=np.float32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    # (w, x, y, z) with w kept positive for canonical form.
    rot[:, 0] = np.abs(rot[:, 0])
    normal = np.zeros((n, 3), np.float32)
    return Gaussians(pos, normal, sh0, sh_rest, opacity, scale, rot)
