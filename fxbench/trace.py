"""The traced stretch: frames under torch.profiler, read back from its
Chrome trace into the device's intervals, the host's ranges and the link
between a kernel and the host call that launched it.

`TraceData` is what a per-layer metric's reader (fxbench/metrics/) reads.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from fxbench import yardstick

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_RANGE = "fxbench.window"
NAME_CHARS = 160     # a device op's name in the breakdown, at most


@dataclasses.dataclass
class DeviceEvent:
    name: str
    cat: str
    start: float            # us, on the trace's clock
    dur: float              # us
    launch: Optional[float]  # us: when the host called the launch


@dataclasses.dataclass
class TraceData:
    """A traced stretch of `frames` frames, and what the run knows besides:
    the host's enqueue time of every frame of the untraced window and the
    yardstick's work of a frame (name -> (bytes, flops))."""
    frames: int
    window: Tuple[float, float]                  # us
    device: List[DeviceEvent]
    ranges: List[Tuple[str, float, float]]       # host ranges, us
    host_ops: List[Tuple[str, float, float]]     # host ops, us
    enqueue_s: List[float]
    work: Dict[str, Tuple[float, float]]

    def in_window(self) -> List[DeviceEvent]:
        lo, hi = self.window
        return [e for e in self.device if e.start < hi and e.start + e.dur > lo]

    def kernels(self) -> List[DeviceEvent]:
        return [e for e in self.in_window() if e.cat == "kernel"]

    def busy_us(self) -> float:
        return yardstick.union_length(
            ((e.start, e.start + e.dur) for e in self.in_window()),
            *self.window)

    def kernel_ms_per_frame(self, match: Callable[[str], bool]) -> float:
        return sum(e.dur for e in self.kernels() if match(e.name)) \
            / 1e3 / self.frames

    def range_device_ms_per_frame(self, names: Sequence[str]
                                  ) -> Optional[float]:
        """Device ms a frame of the kernels launched inside any host range
        of `names`; None where no such range was recorded."""
        spans = sorted((s, e) for n, s, e in self.ranges if n in names)
        if not spans:
            return None
        starts = [s for s, _ in spans]
        total = 0.0
        for k in self.kernels():
            if k.launch is None:
                continue
            # the ranges of `names` do not overlap one another
            i = bisect.bisect_right(starts, k.launch) - 1
            if i >= 0 and k.launch <= spans[i][1]:
                total += k.dur
        return total / 1e3 / self.frames


def load_chrome_trace(path: str, frames: int, enqueue_s, work) -> TraceData:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    launch_at = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            cid = (e.get("args") or {}).get("correlation")
            if cid is not None:
                launch_at[cid] = float(e["ts"])
    device, ranges, ops = [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, ts, dur = e.get("cat"), float(e.get("ts", 0)), float(e.get("dur", 0))
        if cat in DEVICE_CATS:
            cid = (e.get("args") or {}).get("correlation")
            device.append(DeviceEvent(e.get("name", ""), cat, ts, dur,
                                      launch_at.get(cid)))
        elif cat == "user_annotation":
            if e.get("name") == WINDOW_RANGE:
                window = (ts, ts + dur)
            else:
                ranges.append((e.get("name", ""), ts, ts + dur))
        elif cat == "cpu_op":
            ops.append((e.get("name", ""), ts, ts + dur))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE} range")
    return TraceData(frames, window, device, ranges, ops, list(enqueue_s),
                     dict(work))


def profile(run_frames: Callable[[], None], frames: int, enqueue_s, work,
            tries: int = 3) -> TraceData:
    """Run `run_frames` (which submits `frames` frames and synchronises)
    under torch.profiler inside the window range, and read the trace.  A
    profile with no device activity is taken again, `tries` times in all;
    then this raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW_RANGE):
                run_frames()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            data = load_chrome_trace(path, frames, enqueue_s, work)
        finally:
            os.unlink(path)
        if data.kernels():
            return data
    raise RuntimeError(f"{tries} profiles recorded no device activity")


def breakdown(data: TraceData, top: int = 10) -> Dict[str, list]:
    """The device operations that took most time in the traced stretch,
    and its longest idle gaps named by what the host was doing then (the
    innermost host range, and the host op, that cover the gap's middle)."""
    by_name: Dict[str, float] = {}
    for e in data.in_window():
        by_name[e.name] = by_name.get(e.name, 0.0) + e.dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = yardstick.gaps(((e.start, e.start + e.dur)
                           for e in data.in_window()), *data.window)
    idle = sorted(idle, key=lambda g: g[0] - g[1])[:top]

    def innermost(spans, t):
        best = None
        for n, s, e in spans:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (n, s, e)
        return best[0] if best else None

    gaps_named = []
    for s, e in idle:
        mid = (s + e) / 2
        rng = innermost(data.ranges, mid) or WINDOW_RANGE
        op = innermost(data.host_ops, mid)
        gaps_named.append([f"{rng} / {op or 'python'}", (e - s) / 1e6])
    return {"device_ops": [[n[:NAME_CHARS], t / 1e6] for n, t in ops],
            "idle_gaps": gaps_named}
