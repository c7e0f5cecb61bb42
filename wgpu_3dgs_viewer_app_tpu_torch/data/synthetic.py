"""Synthetic splat scenes for tests and benchmarks (host-side numpy).

Each maker gives the same arrays as the JAX package's maker of the same name
for the same arguments. The 6M-splat single-model frame uses
`make_random_scene` with `extent=2.0, scale_range=(0.004, 0.02)`;
`make_inria_like_scene` has the statistics of a trained capture and
`make_grid_scene` is a small deterministic grid.
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


def make_inria_like_scene(
    n: int,
    seed: int = 0,
    scene_scale: float = 4.0,
) -> Gaussians:
    """Synthetic scene with the statistics of a trained model.

    Follows the distributions of Inria-trained outdoor captures (the
    garden/bicycle class) rather than a uniform random cloud:

    - positions on SURFACES: a ground plane, a handful of object blobs, and
      a sparse far background shell (trained splats concentrate on geometry);
    - anisotropic log-normal scales with a squashed minor axis (training
      flattens splats into surface-aligned discs);
    - bimodal opacity (a dense near-opaque mode plus a translucent tail);
    - SH energy decaying by degree (deg1 > deg2 > deg3), as in trained SH.
    """
    rng = np.random.Generator(np.random.SFC64(seed))
    f32 = np.float32

    def unit(shape):
        v = rng.standard_normal(shape, dtype=f32)
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)

    # --- positions: ground 45% / objects 40% / background shell 15% ---
    n_ground = int(n * 0.45)
    n_obj = int(n * 0.40)
    n_bg = n - n_ground - n_obj
    ground = np.stack(
        [
            rng.uniform(-scene_scale, scene_scale, n_ground),
            rng.normal(-0.6 * scene_scale, 0.02 * scene_scale, n_ground),
            rng.uniform(-scene_scale, scene_scale, n_ground),
        ],
        axis=1,
    ).astype(f32)
    n_blobs = 6
    centers = rng.uniform(-0.5 * scene_scale, 0.5 * scene_scale, (n_blobs, 3)).astype(f32)
    centers[:, 1] = rng.uniform(-0.5 * scene_scale, 0.1 * scene_scale, n_blobs)
    which = rng.integers(0, n_blobs, n_obj)
    radii = rng.uniform(0.08, 0.25, n_blobs).astype(f32) * scene_scale
    objs = (
        centers[which]
        + unit((n_obj, 3)) * radii[which][:, None]
        * rng.beta(4.0, 1.0, (n_obj, 1)).astype(f32)  # surface-biased
    ).astype(f32)
    bg = (unit((n_bg, 3)) * rng.uniform(2.0, 3.0, (n_bg, 1)) * scene_scale).astype(f32)
    pos = np.concatenate([ground, objs, bg])

    # --- anisotropic disc-like scales (log-normal, minor axis squashed) ---
    base = rng.normal(np.log(0.008 * scene_scale), 0.7, (n, 1)).astype(f32)
    aniso = rng.normal(0.0, 0.35, (n, 3)).astype(f32)
    scale = base + aniso
    minor = rng.integers(0, 3, n)
    scale[np.arange(n), minor] -= rng.gamma(2.0, 0.6, n).astype(f32)
    scale = np.clip(scale, np.log(1e-4 * scene_scale), np.log(0.1 * scene_scale))

    # --- bimodal opacity ---
    hi = rng.beta(8.0, 1.3, n).astype(f32)     # near-opaque mode
    lo = rng.beta(1.5, 6.0, n).astype(f32)     # translucent tail
    take_hi = rng.random(n) < 0.62
    opacity = inverse_sigmoid(
        np.clip(np.where(take_hi, hi, lo), 0.02, 0.995)
    ).astype(f32)

    # --- colors: natural albedos; SH energy decay by degree ---
    albedo = np.clip(
        0.25 + 0.5 * rng.dirichlet((2.0, 2.0, 2.0), n).astype(f32) * 3.0 / 2.0
        + rng.normal(0, 0.08, (n, 3)).astype(f32),
        0.02,
        0.98,
    )
    sh0 = ((albedo - 0.5) / f32(0.28209479177387814)).astype(f32)
    sh_rest = np.empty((n, 15, 3), f32)
    deg_std = {1: 0.16, 2: 0.07, 3: 0.03}
    k = 0
    for deg in (1, 2, 3):
        cnt = 2 * deg + 1
        sh_rest[:, k : k + cnt, :] = rng.normal(
            0.0, deg_std[deg], (n, cnt, 3)
        ).astype(f32)
        k += cnt

    rot = rng.standard_normal((n, 4), dtype=f32)
    rot /= np.linalg.norm(rot, axis=1, keepdims=True)
    rot[:, 0] = np.abs(rot[:, 0])
    normal = np.zeros((n, 3), f32)
    return Gaussians(pos, normal, sh0, sh_rest, opacity.reshape(n), scale, rot)


def make_grid_scene(side: int = 8, spacing: float = 0.5, scale: float = 0.08) -> Gaussians:
    """Small deterministic grid of isotropic splats (golden tests)."""
    xs = (np.arange(side) - (side - 1) / 2) * spacing
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)
    n = pos.shape[0]
    g = make_random_scene(n, seed=1)
    g.pos = pos
    g.scale = np.full((n, 3), np.log(scale), np.float32)
    g.rot = np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1))
    return g
