"""The harness finds a configuration, a traffic mix and a per-layer
metric added as new files, with no existing file edited."""

import hashlib
import json
import shutil
from pathlib import Path

from flowbench import harness, layout


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in Path(root).rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(layout.HERE, tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = layout.load_benchmark()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    before = _digests(tmp_path)
    fb = tmp_path / "flowbench"
    config = json.loads((fb / "configs" / "tvl1-sintel.json").read_text())
    config["frame"] = {"ny": 32, "nx": 48, "channels": 1}
    (fb / "configs" / "tvl1-tiny.json").write_text(json.dumps(config))
    traffic = json.loads((fb / "traffic" / "pair.json").read_text())
    traffic.update(roster=3, warmup_calls=1, trace_calls=3)
    (fb / "traffic" / "trio.json").write_text(json.dumps(traffic))
    (fb / "metrics" / "calls_traced.trio.py").write_text(
        "def read(record):\n    return float(record.calls)\n")
    bench["workloads"].append({"name": "tvl1-tiny.trio", "config": "tvl1-tiny",
                               "traffic": "trio", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "calls_traced.trio", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "entry and plain ops",
                               "moves": "call_ms_mean",
                               "workloads": ["tvl1-tiny.trio"]})
    for name in ("call_ms_mean", "call_ms_p90"):
        bench["end_to_end"].append({"name": name, "unit": "ms", "better": "lower",
                                    "bound": 0.25, "source": "host_clock",
                                    "workloads": ["tvl1-tiny.trio"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(tmp_path)
    changed = [p for p in before if p != Path("BENCHMARK.json")
               and after[p] != before[p]]
    assert not changed

    cell = layout.Cell(layout.load_benchmark(tmp_path), "tvl1-tiny.trio", fb)
    traced = harness.run(cell, 7, 0.3, 1, "cpu")
    assert traced["correct"]
    assert traced["metrics"]["calls_traced.trio"]["value"] == traced["attempted"]
    timed = harness.run(cell, 7, 0.3, 0, "cpu")
    assert timed["correct"]
    assert set(timed["metrics"]) == {"call_ms_mean", "call_ms_p90", "setup_s"}
    assert list(timed)[-1] == "checks"
