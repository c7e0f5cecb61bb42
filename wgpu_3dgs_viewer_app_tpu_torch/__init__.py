"""PyTorch/CUDA port of the 3D Gaussian Splatting viewer framework.

The JAX package `wgpu_3dgs_viewer_app_tpu` is the reference this port is
held against; this package imports torch and never JAX. The single-model
frame, edits and selection gates included, runs through three hand-written
CUDA kernels for Hopper (`csrc/`): the fused front-end, the entry sort and
the tile compositor; selection and hit queries read a fourth, the
query-geometry pass. Each kernel has a plain torch version that CPU
tensors take.
"""

from . import app, core, data, ops, query, utils, viewer

__version__ = "0.1.0"
