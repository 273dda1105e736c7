"""The benchmark's general code: one cell of ``BENCHMARK.json`` from its
configuration file, its traffic file, its per-layer metric readers and its
limits, all found by name."""
