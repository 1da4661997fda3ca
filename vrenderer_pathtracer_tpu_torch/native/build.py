"""Build the port's copy of the host library (SBVH builder, mesh, MERL, EXR
and FBX I/O).

``csrc/sbvh.cc``, ``loaders.cc``, ``exr.cc``, ``piz.cc``, ``dwa.cc``,
``fbx.cc`` and ``math3.h`` are byte-identical copies of the JAX package's
``native/csrc`` files, with the same C ABI; the port keeps its own copy
because it imports nothing of the JAX package (``dense.cc``, the TPU dense
page builder, is not copied).  They are compiled with ``g++`` at first use
into ``vrenderer_pathtracer_tpu_torch/_build/`` (git-ignored), under a file
name keyed by a hash of the sources and flags, so an edited source builds
anew, and linked against zlib (EXR ZIP/PXR24/DWA and FBX deflate).  The
flags are the JAX package's, so the same machine builds a bit-identical
tree and the same EXR bytes.

Usage:  python -m vrenderer_pathtracer_tpu_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / "csrc"
BUILD_DIR = HERE.parent / "_build"

SOURCES = ["sbvh.cc", "loaders.cc", "fbx.cc", "exr.cc", "piz.cc", "dwa.cc"]
CXXFLAGS = [
    "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
    "-Wall", "-Wextra", "-fno-exceptions",
]
LIBS = ["-lz"]


def library_path() -> pathlib.Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(CXXFLAGS + LIBS).encode())
    for p in [*(CSRC / s for s in SOURCES), *sorted(CSRC.glob("*.h"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libvtrace_host-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the library unless one from the same sources exists.  Raises
    with the compiler's output on failure."""
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host library "
                           "(SBVH builder, loaders) needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, *(str(CSRC / s) for s in SOURCES), "-o", str(tmp),
           *LIBS]
    if verbose:
        print(" ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed:\n{' '.join(cmd)}\n"
                           f"{proc.stderr}")
    if verbose and proc.stderr:
        print(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


if __name__ == "__main__":
    print(f"built {build(verbose=True)}")
    sys.exit(0)
