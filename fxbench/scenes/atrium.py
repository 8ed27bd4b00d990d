"""The procedural atrium (a frozen copy of the port's
examples/benchmark_suite.py `sponza_like_entries`): columns with high-poly
capitals on box shafts, a 60 m floor and clutter spheres.  24 columns and
40 spheres make 165,152 triangles at every seed.

The seed draws the clutter spheres' places and materials in the suite's
order; seed 0 reproduces the suite's scene, which draws them from
np.random.default_rng(0).
"""
from __future__ import annotations

import numpy as np

from fxbench.scenes.primitives import cube, plane, uv_sphere


def _node(translate, scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    m = np.diag(list(scale) + [1.0]).astype(np.float32)
    m[3, :3] = translate
    return m


def build(seed: int, n_columns: int = 24, wall_segments: int = 24,
          clutter_spheres: int = 40):
    """[(mesh, node matrix, material dict)] in the suite's order."""
    rng = np.random.default_rng(seed)
    entries = []
    col = uv_sphere(0.5, 40, 56)
    box = cube(1.0)
    for i in range(n_columns):
        x = (i % (n_columns // 2)) * 2.5 - (n_columns // 4) * 2.5
        z = -4.0 if i < n_columns // 2 else 4.0
        entries.append((col, _node([x, 1.8, z]),
                        dict(base_color_factor=(0.75, 0.7, 0.6, 1.0),
                             roughness_factor=0.55)))
        entries.append((box, _node([x, 0.9, z], (0.5, 3.6, 0.5)),
                        dict(base_color_factor=(0.7, 0.65, 0.55, 1.0),
                             roughness_factor=0.6)))
    entries.append((plane(60.0, segments=wall_segments),
                    np.eye(4, dtype=np.float32),
                    dict(base_color_factor=(0.5, 0.45, 0.4, 1.0),
                         roughness_factor=0.25)))
    sphere = uv_sphere(0.35, 24, 32)
    for _ in range(clutter_spheres):
        node = _node([rng.uniform(-12, 12), 0.4, rng.uniform(-3, 3)])
        entries.append((sphere, node, dict(
            base_color_factor=tuple(rng.uniform(0.2, 0.9, 3)) + (1.0,),
            metallic_factor=float(rng.uniform(0, 1)),
            roughness_factor=float(rng.uniform(0.1, 0.9)))))
    return entries
