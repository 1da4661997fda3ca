"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each library is one ``csrc/<name>.cu`` (plus the shared ``*.cuh``) with a
plain C entry point, compiled for Hopper (``sm_90a``) at first use into
``_build/`` (git-ignored) under a file name keyed by a hash of the sources
and flags, so an edited source builds anew and an unchanged one is reused.
Nothing is built at import.  ``build_all`` starts one ``nvcc`` per source
at once; a target may also be ``(name, extra_flags)``, a build of the same
source with more flags into a library of its own (``chip_smoke.py`` builds
K1's check instances, ``-DVPT_CHECK_INSTANCES``, with and without FMA
contraction, and K3b's; ``cornell_cuts.py`` each mix of the inexact cuts;
``k3b_cuts.py`` K3b's check build with each ingredient or fetch constant
changed).

No ``--use_fast_math``: the kernels keep IEEE division and square root so
they stay comparable with their plain PyTorch versions.

Usage:  python -m vrenderer_pathtracer_tpu_torch.kernels.build [name ...]
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import sys

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
KERNELS = ("radiance", "grad", "traverse", "mesh", "paged", "probe", "draws")
# csrc/<name>.cu: K1, K2, K3 + K3b, K4, K5, K6, K7

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix.  Raises if there is none."""
    candidates = [os.path.join(os.environ[v], "bin", "nvcc")
                  for v in ("CUDA_HOME", "CUDA_PATH") if v in os.environ]
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _sources(name: str) -> list[pathlib.Path]:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    return [src, *sorted(CSRC.glob("*.cuh"))]


def _target(target) -> tuple[str, tuple[str, ...]]:
    """``name`` or ``(name, extra_flags)`` as ``(name, extra_flags)``."""
    if isinstance(target, str):
        return target, ()
    name, extra = target
    return name, tuple(extra)


def library_path(target) -> pathlib.Path:
    """Where the library built from the current sources lives (``target``:
    a kernel name, or ``(name, extra_flags)``)."""
    name, extra = _target(target)
    h = hashlib.sha256(" ".join([*NVCC_FLAGS, *extra]).encode())
    for p in _sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(targets, verbose: bool = False) -> dict:
    """Compile ``csrc/<name>.cu`` for each target (a name, or ``(name,
    extra_flags)``) whose library from the same sources and flags does not
    exist yet, one ``nvcc`` process per target, all started together.
    Returns ``{target: library path}``; raises with nvcc's output if any
    build fails."""
    libs = {target: library_path(target) for target in targets}
    jobs = []
    for target, lib in libs.items():
        if lib.is_file():
            continue
        name, extra = _target(target)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, lib, tmp, cmd, proc))
    failed = []
    for name, lib, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{out}")
            continue
        if verbose:
            print(" ".join(cmd))
            print(out)
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def build(name: str, verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless a library from the same sources
    exists.  Returns the library path; raises with nvcc's output on a
    failed build."""
    return build_all([name], verbose)[name]


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load the library; one handle per process."""
    return ctypes.CDLL(str(build(name)))


if __name__ == "__main__":
    for n, lib in build_all(sys.argv[1:] or KERNELS, verbose=True).items():
        print(f"built {n}: {lib}")
