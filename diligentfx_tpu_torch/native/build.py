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

`build(asan=True)` compiles the same sources with AddressSanitizer into a
library of its own name (the JAX package's native/build.py:20-33).  A
process that loads it calls `use_library(path)` before its first native
call (and runs with libasan preloaded, which must come before libc);
native/binding.py and radient/c_api.py then both bind it.  No
environment variable chooses the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import platform
import subprocess
from pathlib import Path
from typing import Dict, Optional, Union

from diligentfx_tpu_torch.utils import shared_lib

SRC = Path(__file__).resolve().parent / "src" / "dfx_native.cpp"
RADIENT_SRC = SRC.with_name("radient_c.cpp")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
ASAN_FLAGS = ("-std=c++17", "-O1", "-g", "-fsanitize=address",
              "-fno-omit-frame-pointer", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_chosen: Optional[Path] = None      # use_library's path; None: build()


def _toolchain() -> str:
    try:
        r = subprocess.run(["g++", "-dumpfullversion"], capture_output=True,
                           text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run: {e}") from e
    return " ".join((r.stdout.strip(), platform.machine(),
                     *platform.libc_ver()))


def library_path(asan: bool = False) -> Path:
    """Where build(asan) puts the library: a name of its own for each
    build, hashed from the sources, the flags and the toolchain."""
    flags = ASAN_FLAGS if asan else CXX_FLAGS
    h = hashlib.sha256()
    for src in (SRC, RADIENT_SRC):
        h.update(hashlib.sha256(src.read_bytes()).digest())
    h.update(" ".join(flags).encode())
    h.update(_toolchain().encode())
    stem = "libdfx_native_asan" if asan else "libdfx_native"
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:12]}.so"


def build(asan: bool = False) -> Path:
    """The library's path, compiled with g++ if it is missing (with
    AddressSanitizer where `asan`).  Raises RuntimeError with the
    compiler's output when the build fails."""
    out = library_path(asan)
    if out.exists():
        return out
    with shared_lib.lock:
        if not out.exists():
            flags = ASAN_FLAGS if asan else CXX_FLAGS
            job = shared_lib.Compile(["g++", *flags], (SRC, RADIENT_SRC),
                                     out)
            if not job.wait():
                raise RuntimeError(f"g++ failed building {SRC.name} and "
                                   f"{RADIENT_SRC.name}:\n"
                                   f"{job.log.read_text()}")
    return out


def use_library(path: Union[str, Path]) -> None:
    """Load the library at `path` (say build(asan=True)) in place of the
    default build, from the next native call on.  Call it before the
    first: once another library is loaded it raises RuntimeError."""
    global _chosen
    path = Path(path).resolve()
    if not path.exists():
        raise RuntimeError(f"use_library: no library at {path}")
    with shared_lib.lock:
        lib = _loaded.get("dfx_native")
        if lib is not None and Path(lib._name).resolve() != path:
            raise RuntimeError(f"use_library: {lib._name} is loaded already")
        _chosen = path


def load() -> ctypes.CDLL:
    """The loaded native library, built at first use (once a process);
    use_library's where it was called."""
    return shared_lib.load(_loaded, "dfx_native",
                           lambda: _chosen if _chosen is not None
                           else build())
