"""PyTorch/CUDA port of the 3D Gaussian Splatting viewer framework.

The JAX package `wgpu_3dgs_viewer_app_tpu` is the reference this port is
held against; this package imports torch and never JAX. A frame of one
model or of several merged by a model rank in the sort key, edits and
selection gates included, runs through hand-written CUDA kernels for Hopper
(`csrc/`): the fused front-end (or, on the staged route, the preprocess
kernel and the enumerate-and-pack kernel), the entry sort and the tile
compositor; selection and hit queries read the query-geometry pass. Each
kernel has a plain torch version that CPU tensors take. `parallel` renders
one frame over the ranks of a `torch.distributed` group, and `data/native.py`
packs splats with a C++ codec built at first use.
"""

from . import app, core, data, mask, ops, parallel, query, utils, viewer

__version__ = "0.1.0"
