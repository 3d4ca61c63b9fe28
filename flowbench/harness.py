"""One run of one cell: inputs from the seed, set-up and warm-up, the
measured or the traced window, the check, and the result line.

Traffic is a closed loop with one caller.  A "batch" mix calls the
method's batched entry on the same `batch` pairs each call; a "pair"
mix calls its single-pair entry on a roster of `roster` distinct pairs,
in turn, so that every pair is called equally often (to within one
call) and the work a texture needs is averaged in every run.  Each call
ends in `torch.cuda.synchronize()`.  The measured window runs calls
until `seconds` have passed and ends with the last call; the traced
window, under `torch.profiler`, ends after `trace_calls` calls (or
`seconds`), since reading a profile of a full window would take
minutes."""

import gc
import statistics
import sys
import time
import traceback

import torch

from flowbench import check, layout
from flowbench.trace import CALL, WINDOW, Trace
from flowbench.traffic import synth


class Device:
    """The device a run uses: the card, or the CPU in the tests."""

    def __init__(self, name):
        self.dev = torch.device(name)
        self.cuda = self.dev.type == "cuda"

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def name(self):
        return torch.cuda.get_device_name(self.dev) if self.cuda else "cpu"

    def peak_bytes(self):
        return torch.cuda.max_memory_allocated(self.dev) if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.dev)


def make_inputs(cell, seed, device):
    """(I0, I1) stacks of the cell's traffic, made from `seed`."""
    ny, nx = cell.config["frame"]["ny"], cell.config["frame"]["nx"]
    t = cell.traffic
    count = t["batch"] if t["kind"] == "batch" else t["roster"]
    return synth.pairs(count, ny, nx, seed, t, device)


class Window:
    """The closed loop over the inputs, and what it keeps for the
    check: each call's fingerprint and its input, the last answer per
    input, each call's latency."""

    def __init__(self, cell, inputs, dev):
        self.cell, self.inputs, self.dev = cell, inputs, dev
        self.batch = cell.traffic["kind"] == "batch"
        self.w = check.weights(*inputs[0].shape[-2:], dev.dev)
        self.params = cell.config["params"]
        self.calls = 0
        self.lat, self.prints, self.order = [], [], []
        self.kept = {}
        self.raised = 0

    def one(self, record):
        k = None if self.batch else self.calls % self.inputs[0].shape[0]
        a, b = self.inputs if self.batch else (self.inputs[0][k],
                                               self.inputs[1][k])
        t = time.perf_counter()
        try:
            if record:
                with torch.profiler.record_function(CALL):
                    u, v = self.cell.method.call(a, b, self.params, self.dev.dev)
                    self.dev.sync()
            else:
                u, v = self.cell.method.call(a, b, self.params, self.dev.dev)
                self.dev.sync()
        except Exception:  # a call that fails is counted and reported
            if not self.raised:
                traceback.print_exc()
            self.raised += 1
            self.calls += 1
            return
        self.lat.append(time.perf_counter() - t)
        self.prints.append(check.fingerprint(u, v, self.w))
        self.order.append(k)
        self.kept[k] = (u, v)
        self.calls += 1

    def run(self, seconds, max_calls=None, record=False):
        start = time.perf_counter()
        while True:
            self.one(record)
            elapsed = time.perf_counter() - start
            if elapsed >= seconds or (max_calls and self.calls >= max_calls):
                return elapsed

    @property
    def answers(self):
        return self.calls * (self.inputs[0].shape[0] if self.batch else 1)


class Record:
    """What a per-layer metric reads (`metrics/<name>.py`'s `read`)."""

    def __init__(self, cell, window, trace, work, peak_bytes, device_name):
        self.cell = cell
        self.calls = len(window.order)
        self.fields = self.calls * (window.inputs[0].shape[0]
                                    if window.batch else 1)
        self.trace = trace
        self.work = work          # per traced call, methods/<method>.work
        self.peak_bytes = peak_bytes
        self.device_name = device_name

    def roofline(self, kernel):
        return self.cell.roofline(kernel)


def end_to_end(cell, window, elapsed, setup_s):
    values = {"setup_s": setup_s}
    if window.batch:
        values["fields_per_s"] = window.answers / elapsed if window.lat else None
    elif window.lat:
        values["call_ms_mean"] = 1e3 * elapsed / window.calls
        values["call_ms_p90"] = 1e3 * (statistics.quantiles(
            window.lat, n=10, method="inclusive")[8] if len(window.lat) > 1
            else window.lat[0])
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if values.get(m["name"]) is not None}


def run(cell, seed, seconds, trace, device="cuda", t0=None):
    """One run; returns the result dict of the contract, `checks` last."""
    t0 = time.perf_counter() if t0 is None else t0
    marks = [("imports", time.perf_counter())]
    dev = Device(device)
    torch.empty(1, device=dev.dev)
    dev.sync()
    marks.append(("context", time.perf_counter()))
    inputs = make_inputs(cell, seed, dev.dev)
    dev.sync()
    marks.append(("inputs", time.perf_counter()))
    dev.reset_peak()
    warm = Window(cell, inputs, dev)
    for i in range(cell.traffic["warmup_calls"]):
        warm.one(record=False)
        marks.append((f"warm{i}", time.perf_counter()))
    dev.sync()
    setup_s = time.perf_counter() - t0
    phases = {name: t - prev for (name, t), prev
              in zip(marks, [t0] + [t for _, t in marks])}
    print("flowbench: set-up " + " ".join(f"{k} {v:.3f}"
                                          for k, v in phases.items()),
          file=sys.stderr)
    del warm   # the warm-up's answers are not judged
    window = Window(cell, inputs, dev)
    gc.collect()
    gc.freeze()
    if trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if dev.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(WINDOW):
                elapsed = window.run(seconds, cell.traffic["trace_calls"],
                                     record=True)
                dev.sync()
    else:
        elapsed = window.run(seconds)
    gc.unfreeze()
    peak = dev.peak_bytes()
    result = {"correct": False, "attempted": window.answers, "failed": 0,
              "metrics": {}, "device": {
                  "platform": "gpu" if dev.cuda else "cpu",
                  "kind": dev.name(), "count": cell.chips,
                  "memory_peak_bytes": peak}}
    if trace:
        tr = Trace(prof)
        del prof
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        work_of = {}
        work = []
        for k in window.order:
            if k not in work_of:
                a, b = inputs if k is None else (inputs[0][k], inputs[1][k])
                work_of[k] = cell.method.work(a, b, cell.config["params"],
                                              dev.dev)
            work.append(work_of[k])
        rec = Record(cell, window, tr, work, peak, dev.name())
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(rec)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        print(f"flowbench: traced {len(window.order)} calls: {tr.summary()}",
              file=sys.stderr)
    else:
        result["metrics"] = end_to_end(cell, window, elapsed, setup_s)
    if dev.cuda:
        torch.cuda.empty_cache()
    correct, failed, checks = check.judge(
        cell, inputs, window.kept, window.prints, window.order, window.w,
        window.raised)
    result["correct"] = correct
    result["failed"] = failed
    result["checks"] = checks
    return result
