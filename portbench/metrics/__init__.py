"""Per-layer metric readers, one file per metric of ``BENCHMARK.json``'s
``per_layer``: ``read(ctx)`` takes a ``harness.Context`` and returns the
value, or None where the run holds nothing to read (no trace, or a trace
that lost activities)."""
