"""Small cells for the CPU tests: the real configurations and mixes at a
frame size, batch and roster that a test run holds.

The single-pair cells are not in BENCHMARK.json (PERF.md, §7); `bench`
adds them with their metrics, as the entries a later PR would add."""

from flowbench import harness, layout

SHAPE = (40, 64)
PAIR_CELLS = {"brox-sintel.pair": "brox-sintel", "tvl1-sintel.pair": "tvl1-sintel"}
PAIR_METRICS = {
    "end_to_end": [("call_ms_mean", "ms"), ("call_ms_p90", "ms")],
    "per_layer": [("k7_roofline.pair", "%"), ("device_idle_share.pair", "%"),
                  ("torch_launches_per_call.pair", "kernels/call"),
                  ("solver_iters_per_call.pair", "iters/call"),
                  ("peak_mem_gb.pair", "GB")],
}


def bench():
    b = layout.load_benchmark()
    for name, config in PAIR_CELLS.items():
        b["workloads"].append({"name": name, "config": config,
                               "traffic": "pair", "chips": 1, "why": "test"})
    for kind, metrics in PAIR_METRICS.items():
        for name, unit in metrics:
            entry = {"name": name, "unit": unit, "better": "lower",
                     "workloads": list(PAIR_CELLS)}
            if kind == "end_to_end":
                entry.update(bound=0.25, source="host_clock")
            else:
                entry.update(source="device_trace", layer="test",
                             moves="call_ms_mean")
            b[kind].append(entry)
    return b


def cell(name, batch=4, roster=3):
    c = layout.Cell(bench(), name)
    c.traffic.update(batch=batch, roster=roster, warmup_calls=1, trace_calls=4)
    c.config["frame"].update(ny=SHAPE[0], nx=SHAPE[1])
    return c


def run(c, seed=2**31 + 5, seconds=0.3, trace=0):
    return harness.run(c, seed, seconds, trace, "cpu")
