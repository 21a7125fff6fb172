"""Per-layer metric readers, one file each, named by the metric's name in
`BENCHMARK.json` before its first dot (`<base>.py`): the names of one
quantity that moves different end-to-end metrics share its reader.  Each has
`read(traced) -> float | None` over a `tracing.Traced` window; None where it
finds nothing to read, and the metric is then left out of the result."""
