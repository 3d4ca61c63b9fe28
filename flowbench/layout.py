"""Where the harness finds each part of a cell, by the names in
BENCHMARK.json: `configs/<config>.json`, `traffic/<traffic>.json`,
`methods/<method>.py` and `reference/<method>.py` (the method named in
the configuration), `metrics/<metric>.py` and `roofline/<kernel>.py`.
A cell, a mix or a metric is added by adding files; no file here or
elsewhere names one."""

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(base, kind, name):
    return json.loads((Path(base) / kind / f"{name}.json").read_text())


def module(base, kind, name):
    """The module in `<base>/<kind>/<name>.py`, loaded from its file (a
    name may hold dots and dashes)."""
    path = Path(base) / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"flowbench_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry, cell_name):
    """A metric without `workloads` is reported in every cell."""
    return "workloads" not in entry or cell_name in entry["workloads"]


class Cell:
    """One entry of `workloads` with everything it names loaded.  With
    `unlisted`, a name `<config>.<traffic>` that BENCHMARK.json does not
    list is loaded from those two files alone, on one chip and with no
    metrics: the readings of a cell that waits for its entry."""

    def __init__(self, bench, name, base=HERE, unlisted=False):
        entries = [w for w in bench["workloads"] if w["name"] == name]
        if not entries and unlisted:
            config, _, traffic = name.partition(".")
            entries = [{"name": name, "config": config, "traffic": traffic,
                        "chips": 1}]
        if len(entries) != 1:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = entries[0]
        self.name = name
        self.chips = self.entry["chips"]
        self.base = Path(base)
        self.config = _json(base, "configs", self.entry["config"])
        self.traffic = _json(base, "traffic", self.entry["traffic"])
        self.method = module(base, "methods", self.config["method"])
        self.reference = module(base, "reference", self.config["method"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m, name)]

    def metric_reader(self, name):
        return module(self.base, "metrics", name)

    def roofline(self, kernel):
        return module(self.base, "roofline", kernel)
