"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into a shared
library with a plain C interface, loaded with ctypes.  Libraries land in
``build/kernels/`` at the repository root (listed in .gitignore), named by
a hash of the source, the csrc headers and the flags, so an edited source
or header rebuilds and an unchanged one loads at once.  Nothing here runs
at import time.

Building and loading are thread-safe (utils/shared_lib.py, which
native/build.py shares): one lock is held around `build`, `load` and
`bind`, so two threads that reach a kernel for the first time together
start one nvcc, and every temporary and log file is named by the process
and the thread that writes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

from diligentfx_tpu_torch.utils import shared_lib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

KERNELS = ("raster_fused", "warp", "march", "gtao", "raster_tiles",
           "warp_multi")                          # csrc/<name>.cu

_loaded: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Callable[..., int]] = {}
# nvcc processes started, by kernel name (each library is built once)
nvcc_starts: Dict[str, int] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """The library of csrc/<name>.cu, tagged with a hash of the source,
    every csrc header (a source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build every named kernel library that is missing, one nvcc process
    per source, all started together.  Returns {name: compiler log}."""
    names = list(names)
    with shared_lib.lock:
        jobs = {}
        for n in names:
            if not library_path(n).exists():
                jobs[n] = shared_lib.Compile([_nvcc(), *NVCC_FLAGS],
                                             CSRC / f"{n}.cu",
                                             library_path(n))
                nvcc_starts[n] = nvcc_starts.get(n, 0) + 1
        failed = [n for n, job in jobs.items() if not job.wait()]
        if failed:
            logs = "\n".join(library_path(n).with_suffix(".log").read_text()
                             for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        return {n: library_path(n).with_suffix(".log").read_text()
                if library_path(n).with_suffix(".log").exists() else ""
                for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built at first use (once a
    process, whichever threads ask)."""
    def built() -> Path:
        build([name])
        return library_path(name)
    return shared_lib.load(_loaded, name, built)


def bind(name: str, symbol: str, argtypes: Sequence) -> Callable[..., int]:
    """csrc/<name>.cu's launcher `symbol`, returning a cudaError_t: built
    and loaded at first use, prototyped once and cached."""
    fn = _bound.get((name, symbol))
    if fn is not None:
        return fn
    with shared_lib.lock:
        fn = _bound.get((name, symbol))
        if fn is None:
            fn = getattr(load(name), symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _bound[(name, symbol)] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
