"""Compile a shared library at first use and load it once a process: the
mechanism that ops/cuda_build.py (nvcc, the CUDA kernels) and
native/build.py (g++, the host runtime) share.

The caller names a library by a hash of what it is built from, so a
finished file is never rewritten.  A compiler writes into a temporary file
and a log named by the process and the thread that started it, and the
library lands by an atomic rename, so another process building the same
library into the same directory does not collide.  One reentrant lock,
`lock`, is held around every build and load of the process: two threads
that reach a library together start one compiler and load it once.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Hashable, Sequence, Union

# reentrant: a loader's build step may take it again
lock = threading.RLock()


class Compile:
    """One compiler process, `cmd -o <temporary> srcs...`, building the
    library `out` from one source or several; its output goes to a log of
    its own until `wait`."""

    def __init__(self, cmd: Sequence[str], srcs: Union[Path, Sequence[Path]],
                 out: Path):
        srcs = [srcs] if isinstance(srcs, Path) else list(srcs)
        out.parent.mkdir(parents=True, exist_ok=True)
        tag = f"{os.getpid()}.{threading.get_ident()}"
        self.out = out
        self.log = out.with_suffix(".log")
        self._tmp = out.with_suffix(f".{tag}.tmp")
        self._tmp_log = out.with_suffix(f".{tag}.log")
        self._log_file = open(self._tmp_log, "w")
        try:
            self._proc = subprocess.Popen(
                [*cmd, "-o", str(self._tmp), *map(str, srcs)],
                stdout=self._log_file, stderr=subprocess.STDOUT)
        except BaseException:
            self._log_file.close()
            self._tmp_log.unlink(missing_ok=True)
            raise

    def wait(self) -> bool:
        """Whether the compiler succeeded.  Its log lands at `log`, and on
        success the library at `out`."""
        rc = self._proc.wait()
        self._log_file.close()
        os.replace(self._tmp_log, self.log)
        if rc == 0:
            os.replace(self._tmp, self.out)
        else:
            self._tmp.unlink(missing_ok=True)
        return rc == 0


def load(cache: Dict[Hashable, ctypes.CDLL], key: Hashable,
         build: Callable[[], Path]) -> ctypes.CDLL:
    """cache[key]; else the library at the path `build()` returns (built
    there if it is missing), loaded under the lock and cached."""
    lib = cache.get(key)
    if lib is not None:
        return lib
    with lock:
        lib = cache.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            cache[key] = lib
        return lib
