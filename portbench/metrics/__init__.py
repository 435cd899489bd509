"""One reader a metric, found by the metric's name in ``BENCHMARK.json``:
``read(ctx)`` returns the metric's value, or None when the run gives it
nothing to read (the harness then leaves the metric out).  ``ctx`` is
built by ``harness.measure``."""
