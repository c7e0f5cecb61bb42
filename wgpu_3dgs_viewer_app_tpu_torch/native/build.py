"""Build the gsnative codec (`gsnative.cpp`) with the system C++ compiler.

    python -m wgpu_3dgs_viewer_app_tpu_torch.native.build

`data/native.py` calls `build()` at first use. The library lands in the
kernels' git-ignored build directory (`ops/kernels.py::BUILD_DIR`), named by
a digest of the source, the flags and what `-march=native` means on this
machine, and is renamed into place atomically, so processes that build at
once race harmlessly and a build directory carried to another machine is
not reused there. The flags are those of the JAX package's build
(`wgpu_3dgs_viewer_app_tpu/native/build.py`): with the same flags, one
machine gives the same floating-point contraction, so the two codecs agree
bit for bit.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

from ..ops.kernels import BUILD_DIR

SRC = Path(__file__).resolve().parent / "gsnative.cpp"
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]


def compiler() -> str | None:
    """The C++ compiler, or None where the machine has none."""
    return shutil.which("g++")


def _target(cxx: str) -> bytes:
    """The compiler's expansion of `-march=native` on this machine: the
    target options (`-m...`, `--param=...`) it passes its compiler proper."""
    r = subprocess.run([cxx, "-march=native", "-###", "-x", "c++", "-c", os.devnull,
                        "-o", os.devnull], capture_output=True, text=True)
    opts = [w.strip('"') for ln in r.stderr.splitlines() if "-march=" in ln for w in ln.split()]
    return " ".join(w for w in opts if w.startswith(("-m", "--param"))).encode()


def build(verbose: bool = False) -> Path:
    """Compile the codec unless a library of this source, these flags and
    this machine is already built; return its path. Raises where there is
    no compiler or the compile fails."""
    cxx = compiler()
    if cxx is None:
        raise FileNotFoundError("g++ not found: the native codec needs a C++ compiler")
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SRC.read_bytes() + _target(cxx))
    out = BUILD_DIR / f"libgsnative_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}_{threading.get_ident()}.tmp")
    cmd = [cxx, *FLAGS, str(SRC), "-o", str(tmp)]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SRC.name}:\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builds race harmlessly
    return out


if __name__ == "__main__":
    print(build(verbose=True))
