"""The readings that a cell's limits are set from, many seeds in one
process (set-up is paid once).

    python3 fxbench/control.py --workload <cell> --seeds 1,2,3 [--control-frames 4] [--program-seeds 4,5,...] [--frames 40]

--seeds: the precision control.  The reference in bfloat16 (frame.py
`lowp`) is put in the program's place: a closed run of --control-frames
frames
from the initial state, each side from its own state, compared with the
float32 reference at the first and the last frame.

--program-seeds: the program's own readings.  The port renders --frames
frames of the cell's mix in a closed loop (untimed) and one more, and its
frames 0 and 1, its seeded frame and the one more are compared as a
benchmark run compares them.

Prints one JSON line a seed: {"side", "seed", the compared numbers}.
Needs the card, as a run does.
"""
import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def control_readings(cfg, mix, entries, frames, device, ibl_from=None):
    """Worst numbers of the bfloat16 reference against the float32 one
    over the first and the last of `frames` frames."""
    from fxbench.reference import compare
    from fxbench.reference.frame import ReferenceFrame
    ref = ReferenceFrame(cfg, entries, device, ibl_from=ibl_from)
    low = ReferenceFrame(cfg, entries, device, lowp=True, ibl_from=ref)
    rad = mix["camera_rad_per_frame"]
    s_ref, s_low = ref.initial_state(), low.initial_state()
    readings = []
    for i in range(frames):
        c_r, d_r, n_r, s_ref = ref.frame(ref.info(i * rad), s_ref)
        c_l, d_l, n_l, s_low = low.frame(low.info(i * rad), s_low)
        if i in (0, frames - 1):
            readings.append(compare.frame_numbers(
                {"color": c_l, "depth": d_l, "node_id": n_l, "state": s_low},
                {"color": c_r, "depth": d_r, "node_id": n_r, "state": s_ref}))
    return compare.worst(readings), ref


def program_readings(cfg, mix, entries, frames, seed, device, ibl_from=None):
    from fxbench import run
    from fxbench.system import ProgramFrame
    prog = ProgramFrame(cfg, entries, device)
    win = run.Window(prog, mix, keep={0, 1, run.kept_frame_index(seed)})
    w = win.run(0, prog.initial_state(), frames=frames)
    win.extra_frame(frames, w.state)
    kept = win.kept
    del prog, win
    numbers, _ = run.check_frames(cfg, entries, kept,
                                  mix["camera_rad_per_frame"], device,
                                  ibl_from=ibl_from)
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--control-frames", type=int, default=4)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fxbench.control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from fxbench import run
    _, cfg, mix, _, _ = run.load_cell(args.workload)
    seeds = [int(x) for x in args.seeds.split(",") if x]
    pseeds = [int(x) for x in args.program_seeds.split(",") if x]
    ibl = None
    for seed in seeds:
        numbers, ibl = control_readings(cfg, mix, run.scene_entries(cfg, seed),
                                        args.control_frames, "cuda", ibl)
        print(json.dumps(dict(side="control", seed=seed, **numbers)),
              flush=True)
        torch.cuda.empty_cache()
    for seed in pseeds:
        numbers = program_readings(cfg, mix, run.scene_entries(cfg, seed),
                                   args.frames, seed, "cuda", ibl)
        print(json.dumps(dict(side="program", seed=seed, **numbers)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
