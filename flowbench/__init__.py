"""flowbench: the benchmark of `tpuflow_torch`, the PyTorch and CUDA port.

One run measures one cell of the repository's BENCHMARK.json (one
configuration under one traffic mix) on the cards of the machine it
starts on:

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix, method,
per-layer metric or kernel sits in a file of its own that the harness
finds by name (`flowbench.layout`), so a cell, a mix or a metric is
added by adding files.  The yardstick lives here too: the input
generator (`traffic/synth.py`), the plain references (`reference/`),
the peaks (`peaks.json`), the operations and bytes of each kernel
(`roofline/`) and the comparison that decides `correct` (`check.py`).
Nothing here imports JAX or the JAX package `tpuflow`.
"""
