"""What the harness and the reference load: nothing named jax, jaxlib,
flax or diligentfx_tpu (whole top-level names: the port's name begins
with the JAX package's), and the reference nothing of the port."""
import json
import subprocess
import sys

from fxbench.run import FORBIDDEN, ROOT

_PROBE = """
import json, sys
sys.path.insert(0, {root!r})
import importlib
for m in {mods!r}:
    importlib.import_module(m)
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""


def _loaded(mods):
    r = subprocess.run([sys.executable, "-c",
                        _PROBE.format(root=ROOT, mods=mods)],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def _metric_modules():
    bench = json.load(open(f"{ROOT}/BENCHMARK.json"))
    return [f"fxbench.metrics.{m['name']}" for m in bench["per_layer"]]


def test_the_harness_loads_no_jax():
    top = _loaded(["fxbench.run", "fxbench.system", "fxbench.trace",
                   "fxbench.control", "fxbench.reference.frame",
                   "fxbench.reference.compare", "fxbench.scenes.atrium"]
                  + _metric_modules())
    assert not top & set(FORBIDDEN), top & set(FORBIDDEN)
    assert "diligentfx_tpu_torch" in top


def test_the_reference_loads_nothing_of_the_port():
    top = _loaded(["fxbench.reference.frame", "fxbench.reference.compare",
                   "fxbench.scenes.atrium", "fxbench.yardstick"])
    assert not top & (set(FORBIDDEN) | {"diligentfx_tpu_torch"}), top
