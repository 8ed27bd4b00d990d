"""Build and load the port's native host runtime: src/dfx_native.cpp (the
content hash, the pool suballocator, the triangulation) and
src/radient_c.cpp (Radient's public C API, which calls dfx_content_hash),
compiled together into one library.

g++ compiles the sources at first use into ``build/native/`` at the
repository root (listed in .gitignore), as a library named by a hash of the
sources, the flags and the toolchain (g++'s version, the machine and its C
library): an edited source, or a checkout copied to another machine,
rebuilds; an unchanged one loads at once.  A failed build raises; nothing
falls back.  Nothing here runs at import time.  Building and loading are
thread-safe through utils/shared_lib.py, which ops/cuda_build.py shares.
"""
from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
from pathlib import Path
from typing import Dict

from diligentfx_tpu_torch.utils import shared_lib

SRC = Path(__file__).resolve().parent / "src" / "dfx_native.cpp"
RADIENT_SRC = SRC.with_name("radient_c.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}


def _toolchain() -> str:
    try:
        r = subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                           text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    return " ".join((r.stdout.strip(), platform.machine(),
                     *platform.libc_ver()))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in (SRC, RADIENT_SRC):
        h.update(hashlib.sha256(src.read_bytes()).digest())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(_toolchain().encode())
    return BUILD_DIR / f"libdfx_native_{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled with g++ if it is missing.  Raises
    RuntimeError with the compiler's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    with shared_lib.lock:
        if not out.exists():
            job = shared_lib.Compile(["g++", *CXX_FLAGS],
                                     (SRC, RADIENT_SRC), out)
            if not job.wait():
                raise RuntimeError(f"g++ failed building {SRC.name} and "
                                   f"{RADIENT_SRC.name}:\n"
                                   f"{job.log.read_text()}")
    return out


def load() -> ctypes.CDLL:
    """The loaded native library, built at first use (once a process)."""
    return shared_lib.load(_loaded, "dfx_native", build)
