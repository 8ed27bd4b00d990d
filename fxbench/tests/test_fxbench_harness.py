"""The harness is driven by data: a cell, a configuration, a mix or a
per-layer metric is added with files alone; and the last line's form."""
import hashlib
import json
import os
import shutil

import pytest

from helpers import cpu_run

from fxbench import run

ROOT = run.ROOT


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "fxbench")):
        for f in files:
            if f.endswith((".py", ".json")):
                p = os.path.join(d, f)
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    open(p, "rb").read()).hexdigest()
    return out


def test_new_cell_config_mix_and_metric_from_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copytree(os.path.join(ROOT, "fxbench"),
                    os.path.join(root, "fxbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _digests(root)
    # a new configuration, a new mix and a new metric: new files only
    cfg = json.load(open(os.path.join(root, "fxbench/configs/atrium_4k.json")))
    cfg.update(name="atrium_1440p", width=2560, height=1440)
    json.dump(cfg, open(os.path.join(root, "fxbench/configs/atrium_1440p.json"),
                        "w"))
    json.dump({"camera_rad_per_frame": 0.05, "frames_in_flight": 3,
               "readback": False},
              open(os.path.join(root, "fxbench/traffic/fast_orbit.json"), "w"))
    with open(os.path.join(root, "fxbench/metrics/traced_frames.py"), "w") as f:
        f.write("def read(t):\n    return float(t.frames)\n")
    # BENCHMARK.json gains entries; no file there before is edited
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["workloads"].append({"name": "atrium_1440p.fast_orbit",
                               "config": "atrium_1440p",
                               "traffic": "fast_orbit", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "traced_frames", "unit": "frames",
                               "better": "higher", "source": "device_trace",
                               "layer": "device", "moves": "frames_per_s",
                               "workloads": ["atrium_1440p.fast_orbit"]})
    json.dump(bench, open(os.path.join(root, "BENCHMARK.json"), "w"))
    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())

    cell, c, mix, e2e, per_layer = run.load_cell("atrium_1440p.fast_orbit",
                                                 root=root)
    assert (c["width"], c["height"]) == (2560, 1440)
    assert mix["frames_in_flight"] == 3
    assert [m["name"] for m in e2e] == ["frames_per_s", "frame_ms_p95",
                                        "setup_s"]
    assert "traced_frames" in [m["name"] for m in per_layer]

    class T:
        frames = 7
    assert run.load_metric("traced_frames", root=root)(T()) == 7.0
    # the metric lists only its own cell
    assert "traced_frames" not in [
        m["name"] for m in run.load_cell("atrium_4k.hold", root=root)[4]]


def test_every_metric_and_cell_resolves():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell, cfg, mix, e2e, per_layer = run.load_cell(w["name"])
        assert cfg["name"] == w["config"]
        assert {m["name"] for m in e2e} == {"frames_per_s", "frame_ms_p95",
                                            "setup_s"}
        assert len(per_layer) == 7
    for m in bench["per_layer"]:
        assert callable(run.load_metric(m["name"]))
        assert m["moves"] == "frames_per_s"


def test_last_line_keys():
    rc, res, err = cpu_run("atrium_4k.hold")
    assert rc == 0
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert set(res["metrics"]) == {"frames_per_s", "frame_ms_p95", "setup_s"}
    for k in ("platform", "kind", "count", "memory_peak_bytes"):
        assert k in res["device"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}:" in err
    # the checks are the last lines on standard error
    assert err.strip().splitlines()[-1].startswith("check ")


def test_no_card_exits_nonzero_without_a_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = run.run(["--workload", "atrium_4k.hold", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out.strip() == ""
