from .compression import (
    ALL_COMPRESSIONS,
    Compressions,
    Cov3dCompression,
    ShCompression,
    flat_pod_to_words,
    pack_gaussians,
    pod_to_tensors,
)
from .gaussian import PLY_GAUSSIAN_POD_DTYPE, PLY_GAUSSIAN_POD_SIZE, Gaussians, inverse_sigmoid, sigmoid
from .ply import PlyError, PlyHeader, PlyReadStats, read_ply, read_ply_chunks, read_ply_header, write_ply
from .synthetic import make_random_scene

__all__ = [
    "ALL_COMPRESSIONS",
    "Compressions",
    "Cov3dCompression",
    "ShCompression",
    "flat_pod_to_words",
    "pack_gaussians",
    "pod_to_tensors",
    "PLY_GAUSSIAN_POD_DTYPE",
    "PLY_GAUSSIAN_POD_SIZE",
    "Gaussians",
    "inverse_sigmoid",
    "sigmoid",
    "PlyError",
    "PlyHeader",
    "PlyReadStats",
    "read_ply",
    "read_ply_chunks",
    "read_ply_header",
    "write_ply",
    "make_random_scene",
]
