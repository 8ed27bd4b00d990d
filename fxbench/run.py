"""The port's benchmark: one run of one cell.

    python3 fxbench/run.py --workload <config>.<mix> --seed N --seconds S --trace 0|1

The cell's configuration (fxbench/configs/<config>.json) and traffic mix
(fxbench/traffic/<mix>.json) are found by the names BENCHMARK.json gives
the workload; the per-layer metrics by their names (fxbench/metrics/).

A run sets up (the scene from the seed, uploaded once; the port's IBL
precompute; the kernels from build/kernels/), warms up the cell's frames,
then submits frames for `--seconds`, each only once the completion event
of the frame `frames_in_flight` before it has passed, and, where the mix
reads back, with its colour copied to pinned host memory.  A frame's
inputs are made on the host and sent without waiting for the stream.  The
window runs from the first submission to the last completion.  After it
one frame more is rendered from the window's final state, and the kept
frames (the window's frames 0 and 1, one of frames 1-32 drawn from the
seed, and that one more) are computed again by the plain reference
(fxbench/reference/) and compared.

With --trace 0 the last line of standard output carries the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from a
stretch of frames under torch.profiler after the untraced window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import NamedTuple  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "diligentfx_tpu")
TRACED_SECONDS = 1.5     # the traced stretch's length, at least
TRACED_FRAMES_MIN = 4
WARMUP_FRAMES = 3        # the first frame's path, then two of the others


def load_cell(workload: str, root: str = ROOT):
    """(the workload's BENCHMARK.json entry, its configuration, its mix,
    the per-layer metrics' entries that list it or list no cells)."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    with open(os.path.join(root, "fxbench", "configs",
                           cell["config"] + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "fxbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    end_to_end = [m for m in bench["end_to_end"]
                  if workload in m.get("workloads", [workload])]
    return cell, cfg, mix, end_to_end, per_layer


def load_metric(name: str, root: str = ROOT):
    """The reader of the per-layer metric `name`:
    fxbench/metrics/<name>.py's `read`."""
    path = os.path.join(root, "fxbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "fxbench.metrics." + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def scene_entries(cfg: dict, seed: int):
    params = dict(cfg["scene"])
    gen = importlib.import_module("fxbench.scenes." + params.pop("generator"))
    return gen.build(seed, **params)


def kept_frame_index(seed: int) -> int:
    """The window frame, besides its first and its last, that the check
    compares: one of frames 1-32, drawn from the seed."""
    import numpy as np
    return 1 + int(np.random.default_rng([seed, 1]).integers(0, 32))


def card_power_limit() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else ""
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return ""


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


class WindowResult(NamedTuple):
    frames: int            # frames submitted (and completed)
    seconds: float         # first submission to last completion
    events: list           # each frame's completion event (None on a CPU)
    enqueue_s: list        # host seconds of each frame's entry call
    nonfinite: object      # frames whose colour held a non-finite value
    raised: int            # frames that raised
    state: object          # the state after the last frame


class Window:
    """The closed loop of frames over one ProgramFrame.  `kept` holds
    copies of what the check reads of the frames in `keep`: the state a
    frame took in (where the reference cannot carry its own), the colour
    (as read back, where the mix reads back), depth, node ids and the
    state it handed on."""

    def __init__(self, prog, mix: dict, keep: set):
        import torch
        self.torch, self.prog = torch, prog
        self.fif = int(mix["frames_in_flight"])
        self.rad = float(mix["camera_rad_per_frame"])
        self.readback = bool(mix["readback"])
        self.keep = set(keep)
        self.kept = {}
        self.host = {}
        # a held camera's inputs are made once, in set-up
        self.fixed = prog.info(0.0) if self.rad == 0.0 else None
        if self.readback:
            for k in list(self.keep) + ["ring0", "ring1"]:
                self.host[k] = self._pinned()

    def _pinned(self):
        prog = self.prog
        return self.torch.empty((prog.height, prog.width, 3),
                                dtype=self.torch.float32,
                                pin_memory=prog.device.type == "cuda")

    def _readback_buffer(self, idx):
        if not self.readback:
            return None
        return self.host[idx] if idx in self.keep else \
            self.host["ring%d" % (idx % 2)]

    def run(self, seconds: float, state, start_index: int = 0,
            frames: int = 0) -> WindowResult:
        """Submit frames from `state` until `seconds` have passed (or,
        with `frames`, that many)."""
        torch, prog = self.torch, self.prog
        on_card = prog.device.type == "cuda"
        events, enqueue = [], []
        bad = torch.zeros((), dtype=torch.int32, device=prog.device)
        raised = 0
        i = 0
        t0 = time.perf_counter()
        while True:
            if i >= self.fif and on_card:
                events[i - self.fif].synchronize()
            if (frames and i >= frames) or (
                    not frames and time.perf_counter() - t0 >= seconds):
                break
            idx = start_index + i
            info = self.fixed if self.fixed is not None else \
                prog.info(idx * self.rad)
            state_in = self._state_in(idx, state)
            t = time.perf_counter()
            try:
                out = prog.submit(info, state)
            except Exception:  # a frame that raises counts as failed
                traceback.print_exc()
                raised += 1
                break
            enqueue.append(time.perf_counter() - t)
            dst = self._readback_buffer(idx)
            if dst is not None:
                dst.copy_(out.color, non_blocking=True)
            bad += (~torch.isfinite(out.color).all()).to(torch.int32)
            ev = None
            if on_card:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
            events.append(ev)
            if idx in self.keep:
                self._hold(idx, state_in, out, dst)
            state = out.state
            i += 1
        if on_card:
            torch.cuda.synchronize(prog.device)
        return WindowResult(i, time.perf_counter() - t0, events, enqueue, bad,
                            raised, state)

    def extra_frame(self, idx: int, state) -> WindowResult:
        """One frame more, past the window's close, kept for the check."""
        self.keep.add(idx)
        if self.readback:
            self.host[idx] = self._pinned()
        return self.run(0, state, start_index=idx, frames=1)

    def _state_in(self, idx, state):
        """A copy of the state frame `idx` takes in, where the check needs
        it: the reference carries its own from frame 0 to a kept frame 1."""
        from fxbench.system import state_dict
        if idx not in self.keep or idx == 0 or (idx - 1) in self.keep:
            return None
        return state_dict(state, clone=True)

    def _hold(self, idx, state_in, out, readback):
        from fxbench.system import state_dict
        self.kept[idx] = {
            "index": idx, "state_in": state_in,
            "color": out.color.clone() if readback is None else readback,
            "depth": out.gbuffer.depth.clone(),
            "node_id": out.gbuffer.mesh_id.clone(),
            "state": state_dict(out.state, clone=True)}


def check_frames(cfg, entries, kept: dict, rad: float, device,
                 ibl_from=None):
    """Compute each kept frame with the reference and compare.  A frame
    whose predecessor was kept too starts from the state the reference
    handed on; frame 0 from the reference's initial state; any other from
    the copy of the state the port handed it.  Returns (the worst
    readings, the readings a frame)."""
    import torch
    from fxbench.reference import compare
    from fxbench.reference.frame import ReferenceFrame
    ref = ReferenceFrame(cfg, entries, device, ibl_from=ibl_from)
    per_frame = {}
    carried = None
    for idx in sorted(kept):
        rec = kept[idx]
        if idx == 0:
            state = ref.initial_state()
        elif carried is not None and carried[0] == idx - 1:
            state = carried[1]
        else:
            state = rec["state_in"]
        color, depth, node_id, new_state = ref.frame(ref.info(idx * rad),
                                                     state)
        per_frame[idx] = compare.frame_numbers(
            {"color": rec["color"], "depth": rec["depth"],
             "node_id": rec["node_id"], "state": rec["state"]},
            {"color": color, "depth": depth, "node_id": node_id,
             "state": new_state})
        carried = (idx, new_state)
        del color, depth, node_id, state
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return compare.worst(per_frame.values()), per_frame


def run(argv=None, device: str = "cuda", hooks=None, override=None) -> int:
    """One run; prints the result line and returns the exit code.
    `device`, `hooks` and `override` are for the CPU tests: "cpu" skips
    the look for a card, `hooks(prog)` may replace parts of the system
    under test, and `override` is merged into the configuration."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell, cfg, mix, end_to_end, per_layer = load_cell(args.workload)
    cfg = dict(cfg, **(override or {}))
    import torch
    if device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            print(f"fxbench: the cell needs {cell['chips']} CUDA device(s); "
                  f"this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fxbench import trace as ftrace
    from fxbench import yardstick
    from fxbench.system import ProgramFrame

    entries = scene_entries(cfg, args.seed)
    prog = ProgramFrame(cfg, entries, device)
    if hooks is not None:
        hooks(prog)
    win = Window(prog, mix, keep={0, 1, kept_frame_index(args.seed)})

    # warm-up: the first frame's path and the later frames' path
    t = time.perf_counter()
    if win.run(0, prog.initial_state(), frames=WARMUP_FRAMES).raised:
        return 1
    win.kept.clear()
    setup = dict(prog.phases, warmup_s=time.perf_counter() - t)
    setup_s = time.perf_counter() - T_START

    w = win.run(args.seconds, prog.initial_state())
    n, window_s, raised, state = w.frames, w.seconds, w.raised, w.state
    attempted = n + raised
    failed = raised + int(w.nonfinite)
    intervals = [w.events[i - 1].elapsed_time(w.events[i])
                 for i in range(1, len(w.events))] if device == "cuda" else []
    # the last frame the check compares: one more of the same path from
    # the window's final state, once the window has closed
    after = win.extra_frame(n, state)
    raised += after.raised
    state = after.state

    traced = None
    if args.trace:
        frame_s = window_s / max(n, 1)
        p = max(TRACED_FRAMES_MIN, math.ceil(TRACED_SECONDS / frame_s))
        work = {"k2": yardstick.k2_work(cfg)}
        vis = _visible(cfg, entries, (n + 1 + p // 2) * win.rad)
        work["k1"] = yardstick.k1_work(cfg["width"], cfg["height"], vis,
                                       len(entries))
        traced = ftrace.profile(
            lambda: win.run(0, state, start_index=n + 1, frames=p), p,
            w.enqueue_s, work)
        unlinked = sorted({k.name[:60] for k in traced.kernels()
                           if k.launch is None})
        print(f"traced: {p} frames, {len(traced.kernels())} kernels, "
              f"without a host launch: {unlinked}", file=sys.stderr)

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    power = card_power_limit() if device == "cuda" else ""
    kept = win.kept
    # the program's objects go before the reference runs; what the check
    # reads stays in `kept`
    del state, prog, win
    if device == "cuda":
        torch.cuda.empty_cache()

    limits = cfg["limits"]
    if raised or not kept:
        numbers = {k: float("nan") for k in limits}
    else:
        t = time.perf_counter()
        numbers, per_frame = check_frames(cfg, entries, kept,
                                          mix["camera_rad_per_frame"], device)
        print(f"check took {time.perf_counter() - t:.3f} s", file=sys.stderr)
        for idx, r in per_frame.items():
            print(f"frame {idx}: {json.dumps(r)}", file=sys.stderr)
    from fxbench.reference.compare import judge
    correct = judge(numbers, limits) and failed == 0

    found = forbidden_modules()
    if found:
        print(f"fxbench: loaded in this process: {found}", file=sys.stderr)
        return 3

    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed}
    if args.trace:
        metrics = {}
        for m in per_layer:
            v = load_metric(m["name"])(traced)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = {"frames_per_s": n / window_s if window_s > 0 else 0.0,
                  "frame_ms_p95": (yardstick.percentile(intervals, 95)
                                   if intervals else float("nan")),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else "cpu", "kind": kind,
           "count": cell["chips"], "memory_peak_bytes": int(peak),
           "power_limit": power}
    if args.trace:
        dev["busy_s"] = traced.busy_us() / 1e6
        dev["window_s"] = (traced.window[1] - traced.window[0]) / 1e6
        result["breakdown"] = ftrace.breakdown(traced)
    result["device"] = dev
    result["setup"] = setup
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in limits}
    for k in limits:
        print(f"check {k}: {numbers[k]!r} (limit {limits[k]!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _visible(cfg, entries, angle):
    """The count of visible triangles of the camera at `angle`, from the
    benchmark's own scene arrays and the reference's camera."""
    import numpy as np
    from fxbench import yardstick
    from fxbench.reference.frame import camera
    world, idx, base = [], [], 0
    for mesh, node, _ in entries:
        world.append(mesh.positions @ node[:3, :3] + node[3, :3])
        idx.append(mesh.indices + base)
        base += len(mesh.positions)
    world, idx = np.concatenate(world), np.concatenate(idx)
    return yardstick.visible_triangles(
        world, idx, camera(cfg, angle, "cpu").view_proj.numpy())


if __name__ == "__main__":
    sys.exit(run())
