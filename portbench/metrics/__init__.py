"""One reader per metric, named as in BENCHMARK.json: ``read(run)`` takes
a ``harness.Run`` and returns the number, or None where the run holds
nothing to read (the harness then leaves the metric out)."""
