"""Reading a `torch.profiler` window: device busy time, kernels by name
and count, and the idle gaps named by what the host was doing.

The harness wraps the traced calls in the user annotation
`flowbench.window` (and each call in `flowbench.call`); this module
reads the profiler's raw events (`kineto_results.events()`) without
building its tree of function events, which costs minutes for a few
hundred thousand kernels."""

import collections

from torch.autograd import DeviceType

WINDOW = "flowbench.window"
CALL = "flowbench.call"
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def short_name(name, width=96):
    """A kernel's name without `void `, anonymous namespaces and its
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    if cut > 0:
        name = name[:cut]
    return name[:width]


def _kind(event, annotations):
    """The event's kind from its device and name: "kernel",
    "gpu_memcpy", "gpu_memset", "gpu_annotation" (a record_function's
    range on the device) or "gpu_sync" on the card; "runtime" (a CUDA
    runtime or driver call), "annotation" or "cpu_op" on the host."""
    name = event.name()
    if event.device_type() == DeviceType.CUDA:
        if name in annotations:
            return "gpu_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        if "Sync" in name or "Wait" in name:
            return "gpu_sync"
        return "kernel"
    if name in annotations:
        return "annotation"
    if name.startswith("cu"):
        return "runtime"
    return "cpu_op"


class Trace:
    """The events of one profiled window."""

    def __init__(self, prof):
        events = prof.profiler.kineto_results.events()
        annotations = {e.name() for e in events
                       if e.device_type() != DeviceType.CUDA
                       and e.name().startswith("flowbench.")}
        window = [e for e in events if e.name() == WINDOW
                  and e.device_type() != DeviceType.CUDA]
        if not window:
            raise RuntimeError(f"the profile holds no {WINDOW!r} annotation")
        w = window[0]
        self.start = w.start_ns()
        self.end = self.start + w.duration_ns()
        self.thread = w.start_thread_id()
        self.device = []   # (start, end, name, kind, linked correlation)
        self.host = []     # (start, end, name, kind) on the window's thread
        self.ops = {}      # correlation id -> kind of a host op or annotation
        self.runtime = set()  # correlation ids of runtime calls
        for e in events:
            kind = _kind(e, annotations)
            start = e.start_ns()
            end = start + e.duration_ns()
            if kind in _DEVICE_OPS:
                s, t = max(start, self.start), min(end, self.end)
                if t > s:
                    self.device.append((s, t, e.name(), kind,
                                        e.linked_correlation_id()))
            elif not kind.startswith("gpu"):
                if kind == "runtime":
                    self.runtime.add(e.correlation_id())
                elif e.correlation_id():
                    self.ops[e.correlation_id()] = kind
                if e.start_thread_id() == self.thread:
                    self.host.append((start, end, e.name(), kind))
        self.device.sort()

    @property
    def window_s(self):
        return (self.end - self.start) * 1e-9

    def busy_intervals(self):
        merged = []
        for s, t, *_ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        return merged

    @property
    def busy_s(self):
        return sum(t - s for s, t in self.busy_intervals()) * 1e-9

    def kernels(self):
        """[(name, start, end, launched under a PyTorch op)] of the
        window's kernels."""
        return [(name, s, t, self.ops.get(corr) == "cpu_op")
                for s, t, name, kind, corr in self.device if kind == "kernel"]

    def summary(self):
        """Counts of the window's device events by kind, and of its
        kernels by the host event they are tied to."""
        out = collections.Counter(kind for *_, kind, _ in self.device)
        for *_, kind, corr in self.device:
            if kind == "kernel":
                tie = self.ops.get(corr) or (
                    "runtime" if corr in self.runtime else "none")
                out[f"kernel_under_{tie}"] += 1
        return dict(out)

    def linked(self):
        """How many of the window's kernels the profiler tied to a host
        event (0 where it ties none: then the launches cannot be told
        apart)."""
        return sum(1 for *_, kind, corr in self.device
                   if kind == "kernel" and corr in self.ops)

    def kernel_time(self, parts):
        """(seconds, count) of the kernels whose name holds one of
        `parts`."""
        sel = [t - s for name, s, t, _ in self.kernels()
               if any(p in name for p in parts)]
        return sum(sel) * 1e-9, len(sel)

    def device_ops(self, top=10):
        total = collections.Counter()
        for s, t, name, *_ in self.device:
            total[short_name(name)] += (t - s) * 1e-9
        return [[n, v] for n, v in total.most_common(top)]

    def idle_gaps(self, top=10):
        """The window's idle device time, summed by the host event that
        was innermost at each gap's middle (`python` where the host was
        in none); a PyTorch runtime call is named with its op."""
        gaps = []
        prev = self.start
        for s, t in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, t)
        if self.end > prev:
            gaps.append((prev, self.end))
        host = sorted(h for h in self.host if h[3] != "annotation")
        total = collections.Counter()
        stack, i = [], 0
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            while i < len(host) and host[i][0] <= mid:
                while stack and stack[-1][1] < host[i][0]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            if not stack:
                name = "python"
            else:
                name = stack[-1][2]
                if stack[-1][3] == "runtime" and len(stack) > 1:
                    name = f"{stack[-2][2]}/{name}"
            total[name] += (g1 - g0) * 1e-9
        return [[n, v] for n, v in total.most_common(top)]
