"""The benchmark's arithmetic on fixed inputs: the p95 interval, the
union-of-intervals idle share, the roofline counts, and the trace reader."""
import json

import numpy as np
import pytest

from fxbench import trace, yardstick
from fxbench.run import load_cell, load_metric


def test_percentile_is_linear_between_ranks():
    vals = list(range(1, 101))                 # 1..100
    assert yardstick.percentile(vals, 95) == pytest.approx(95.05)
    assert yardstick.percentile([5.0] * 10 + [50.0], 95) == \
        pytest.approx(27.5)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (9, 12)]
    assert yardstick.union_length(iv, 0, 10) == pytest.approx(3 + 1 + 1)
    assert yardstick.gaps(iv, 0, 10) == [(3, 5), (6, 9)]
    assert yardstick.gaps([], 0, 4) == [(0, 4)]


def test_least_seconds_takes_the_larger_bound():
    assert yardstick.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert yardstick.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert yardstick.least_seconds(3.35e9, 67e12) == pytest.approx(1.0)


def test_k1_work_counts_the_frames_sizes():
    nbytes, flops = yardstick.k1_work(3840, 2160, 1000, 89)
    px = 3840 * 2160
    assert nbytes == px * 27 * 4 + 1000 * 128 + 89 * 18 * 4
    assert flops == px * 47


def test_k2_warps_of_the_two_configurations():
    _, c4k, _, _, _ = load_cell("atrium_4k.hold")
    # the 1080p deferred frame of BASELINE config 3: no TAA, no bloom
    c3 = dict(c4k, width=1920, height=1080, task_manager=dict(
        c4k["task_manager"], enable_taa=False, enable_bloom=False))
    w4k, w3 = yardstick.k2_warps(c4k), yardstick.k2_warps(c3)
    assert len(w4k) == 19 and len(w3) == 18
    assert w4k[0] == (2160, 3840, 1) and w4k[-1] == (2160, 3840, 4)
    assert w3[1] == (540, 960, 1) and w3[-1] == (540, 960, 2)
    nbytes, _ = yardstick.k2_work(c3)
    assert nbytes == (1920 * 1080 * 4 + 16 * 540 * 960 * 4
                      + 540 * 960 * 6) * 4


def test_visible_triangles():
    pos = np.array([[-1, -1, 5], [1, -1, 5], [0, 1, 5],
                    [-1, -1, 5], [0, 1, 5], [1, -1, 5],
                    [-1, -1, -5], [1, -1, -5], [0, 1, -5]], float)
    idx = np.arange(9).reshape(3, 3)
    # a camera at the origin looking down -z is the identity view here:
    # clip = (x, y, -z, -z) puts z = -5 in front, z = 5 behind
    vp = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, -0.5, -1],
                   [0, 0, 0, 0]], float)
    # triangle 2 is in front and counter-clockwise; 0 and 1 lie behind
    assert yardstick.visible_triangles(pos, idx, vp) == 1


def _synthetic_trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "fxbench.window",
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "dfx.gbuffer",
         "ts": 10, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "dfx.context_composite",
         "ts": 120, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 20, "dur": 5, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 30, "dur": 5, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 130, "dur": 5, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "raster_fused_kernel",
         "ts": 100, "dur": 200, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "elementwise",
         "ts": 50, "dur": 100, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "warp_tap_vec<float4>",
         "ts": 400, "dur": 100, "args": {"correlation": 3}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 700, "dur": 100, "args": {"correlation": 9}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 600,
         "dur": 30},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    work = {"k1": (3.35e12 * 100e-6, 0.0), "k2": (3.35e12 * 50e-6, 0.0)}
    return trace.load_chrome_trace(str(p), 2, [0.01, 0.03], work)


def test_trace_reader_and_metrics(tmp_path):
    t = _synthetic_trace(tmp_path)
    read = {n: load_metric(n)(t) for n in (
        "enqueue_ms", "gbuffer_device_ms", "post_device_ms",
        "k1_roofline_pct", "k2_roofline_pct", "device_idle_pct",
        "launches_per_frame")}
    assert read["enqueue_ms"] == pytest.approx(20.0)
    # the gbuffer range launched K1 (driver) and the elementwise kernel
    assert read["gbuffer_device_ms"] == pytest.approx(0.3 / 2)
    assert read["post_device_ms"] == pytest.approx(0.1 / 2)
    # K1: 100 us of least time a frame over 100 us a frame
    assert read["k1_roofline_pct"] == pytest.approx(100.0)
    assert read["k2_roofline_pct"] == pytest.approx(100.0)
    # busy: [50, 300] + [400, 500] + [700, 800] = 450 of 1000
    assert read["device_idle_pct"] == pytest.approx(55.0)
    assert read["launches_per_frame"] == pytest.approx(1.5)
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["raster_fused_kernel", 200e-6]
    assert b["idle_gaps"][0][1] == pytest.approx(200e-6)
    assert "aten::add" in b["idle_gaps"][0][0]


def test_a_metric_with_nothing_to_read_returns_none(tmp_path):
    t = _synthetic_trace(tmp_path)
    t.device = [e for e in t.device if "raster" not in e.name]
    assert load_metric("k1_roofline_pct")(t) is None
    t.ranges = []
    assert load_metric("gbuffer_device_ms")(t) is None
