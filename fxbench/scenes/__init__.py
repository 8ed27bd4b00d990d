"""Scene generators of the benchmark, one module a generator, found by the
name a configuration file gives under `scene.generator`.  Each module's
`build(seed, **params)` returns the scene as plain numpy: a list of
(MeshData, node matrix (4, 4) float32, material dict) entries."""
