"""The benchmark's plain reference: frozen copies of the port's plain torch
and numpy paths (pack, preprocess, enumerate and pack, stable sort,
compositor, mask shapes and gizmos, rect selection, overlays, PLY), with the
CUDA dispatch taken out. It imports nothing of the port and nothing of JAX;
the benchmark's correctness check runs it on inputs it makes itself."""
