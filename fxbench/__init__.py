"""The benchmark of the PyTorch and CUDA port (`diligentfx_tpu_torch`).

`run.py` runs one cell of BENCHMARK.json; `configs/`, `traffic/`,
`scenes/` and `metrics/` hold one configuration, traffic mix, scene
generator or per-layer metric a file, found by name; `system.py` builds
the port's objects; `trace.py` reads the traced stretch; `yardstick.py`
holds the peaks, the statistics and the roofline counts; `reference/` is
the plain reference and the comparison that decides `correct`;
`control.py` reads the limits' readings; `tests/` are its CPU tests
(`python -m pytest fxbench/tests -q`; `-m cuda` on the card).

Nothing here imports JAX or the JAX package, and the reference imports
nothing of the port.
"""
