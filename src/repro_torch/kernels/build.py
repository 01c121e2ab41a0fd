"""Build the port's CUDA sources (``repro_torch/csrc/*.cu``) with nvcc into
shared libraries with a plain C interface, and load them with ctypes.

A library is built at first use into ``build/kernels/`` at the root of the
checkout, under a name keyed by a hash of its source and the compiler flags,
so an edited source is rebuilt and an unchanged one is reused.
``build_all`` starts one nvcc per source, all at once.
Nothing here runs at import: the CPU tests import every module, and a host
without nvcc never reaches this code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = ("sim_step", "contention")

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}   # name -> nvcc's output (ptxas -v report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a host with the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}.{digest[:16]}.so"


def build(name: str) -> float | None:
    """Compile ``csrc/<name>.cu`` unless its library exists. Returns the
    compile's seconds, or None when it was already built. Raises with
    nvcc's output if the compile fails."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.monotonic()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(CSRC / f"{name}.cu")], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True, check=False)
    build_log[name] = proc.stdout
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)   # atomic: a reader never sees half a file
    return time.monotonic() - t0


def build_all() -> dict[str, float | None]:
    """``build`` every source, one nvcc each, all started together.
    Returns {name: its compile's seconds or None}; raises as ``build``
    does once every compile has ended."""
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return dict(zip(SOURCES, pool.map(build, SOURCES)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build(name)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
