"""Per-layer metrics, one reader a file, named as in BENCHMARK.json.

Each gives `read(record)` -> a number, or None where the traced run
holds nothing to read (then the harness leaves the metric out).  The
record (flowbench.harness.Record) holds the trace of the window, the
work of each traced call (methods/<method>.work), the peak memory and
the cell."""
