"""Kernel builds from several threads (diligentfx_tpu_torch/ops/cuda_build.py
and utils/shared_lib.py).

With a fake nvcc (a stand-in for subprocess.Popen that sleeps, then writes
its output file) and a stand-in for ctypes.CDLL, eight (and sixteen)
threads that reach the same kernels together, with the interpreter's
switch interval shortened, start one nvcc for each library and load each
library once; every temporary and log file of a build is its own."""
import sys
import threading
import time
import types
from pathlib import Path

import pytest

from diligentfx_tpu_torch.ops import cuda_build
from diligentfx_tpu_torch.utils import shared_lib


class _FakeNvcc:
    """subprocess.Popen's stand-in: records the command, and on wait()
    writes the -o file (after a pause that lets other threads in)."""
    started = []
    lock = threading.Lock()

    def __init__(self, cmd, stdout=None, stderr=None):
        with self.lock:
            self.started.append(list(cmd))
        self.out = Path(cmd[cmd.index("-o") + 1])
        stdout.write("ptxas info    : Used 8 registers\n")

    def wait(self):
        time.sleep(0.05)
        self.out.write_bytes(b"\x7fELF fake library")
        return 0


class _FakeLibrary:
    """ctypes.CDLL's stand-in: every symbol is a prototype-able object."""

    def __getattr__(self, symbol):
        fn = types.SimpleNamespace()
        setattr(self, symbol, fn)
        return fn


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    loads = []
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(shared_lib.subprocess, "Popen", _FakeNvcc)
    monkeypatch.setattr(cuda_build.ctypes, "CDLL",
                        lambda path: loads.append(path) or _FakeLibrary())
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_bound", {})
    monkeypatch.setattr(cuda_build, "nvcc_starts", {})
    _FakeNvcc.started = []
    return loads


def _in_threads(fn, n=8):
    """fn(i) on n threads released together; the results in order."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def run(i):
        try:
            barrier.wait(30)
            results[i] = fn(i)
        except Exception as e:          # reported below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


@pytest.mark.parametrize("n", [8, 16])
def test_load_from_many_threads_builds_once(fake_toolchain, n):
    libs = _in_threads(lambda i: cuda_build.load("warp"), n)
    assert cuda_build.nvcc_starts == {"warp": 1}
    assert len(_FakeNvcc.started) == 1
    assert fake_toolchain == [str(cuda_build.library_path("warp"))]
    assert all(lib is libs[0] for lib in libs)
    # the finished library and its log under their own names; no
    # temporary or per-thread log left behind
    names = sorted(p.name for p in cuda_build.BUILD_DIR.iterdir())
    lib = cuda_build.library_path("warp")
    assert names == sorted([lib.name, lib.with_suffix(".log").name])
    assert "registers" in lib.with_suffix(".log").read_text()


def test_threads_on_different_kernels_build_each_once(fake_toolchain):
    names = cuda_build.KERNELS
    fns = _in_threads(lambda i: cuda_build.bind(names[i % len(names)],
                                                "dfx_launch", []), 12)
    assert cuda_build.nvcc_starts == {n: 1 for n in names}
    for i, fn in enumerate(fns):         # one prototype per library
        assert fn is fns[i % len(names)]
    assert sorted(fake_toolchain) == sorted(
        str(cuda_build.library_path(n)) for n in names)


def test_temporary_names_are_per_thread(fake_toolchain):
    """The temporary output and log of a build carry the process id and
    the thread id."""
    cuda_build.load("march")
    (cmd,) = _FakeNvcc.started
    tmp = Path(cmd[cmd.index("-o") + 1])
    tag = f".{cuda_build.os.getpid()}.{threading.get_ident()}.tmp"
    assert tmp.name.endswith(tag)
    assert not tmp.exists()
