"""Shared pieces of the benchmark's CPU tests: a run of a cell on the CPU
at a small size, its result line parsed."""
import contextlib
import io
import json

# a small frame and small IBL tables, so that a CPU run takes seconds
SMALL = {"width": 256, "height": 128,
         "renderer": {"num_brdf_samples": 64, "brdf_lut_dim": 64,
                      "irradiance_cube_dim": 16, "prefiltered_env_map_dim": 32,
                      "num_specular_env_samples": 32}}


def cpu_run(workload, seed=4294967301, seconds=2.0, override=None,
            hooks=None):
    """(exit code, the result line as a dict or None, standard error)."""
    import torch
    from fxbench import run
    torch.set_num_threads(1)
    out, err = io.StringIO(), io.StringIO()
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0"]
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.run(argv, device="cpu", hooks=hooks,
                     override=dict(SMALL, **(override or {})))
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
