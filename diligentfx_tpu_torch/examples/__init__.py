"""The example entry points of the JAX package's examples/ directory that
the port carries: benchmark_suite.py (the BASELINE.json configurations as
builders, and a timing main) and render_mr_spheres.py (configuration 1's
scene and frame).  Run them as modules:

    python -m diligentfx_tpu_torch.examples.benchmark_suite --configs 1,2,3,4,5 --frames 10
    python -m diligentfx_tpu_torch.examples.render_mr_spheres --size 512 --out mr_spheres.png
"""
