"""Per-layer metrics, one module a metric, found by the metric's name in
BENCHMARK.json.  Each module's `read(trace)` takes the traced run's
fxbench.trace.TraceData and returns the number, or None where it finds
nothing to read (the harness then leaves the metric out)."""
