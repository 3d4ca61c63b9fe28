"""What the readers of the program's own spans and counters share
(`tpuflow_torch.utils.trace`, kept while the profiler records).

The window's calls are the program's root spans that lie inside the
traced window; the host clock of the spans is the clock of the
profiler's host events, so the window's start and end select them.
Their counters are summed over those calls, and the device's busy
intervals are laid over the spans.  Each device event is also tied to
the span it was launched in: on the one stream the calls use, the card
runs its kernels, copies and fills in the order of their launches, so
the i-th launch on the calls' thread is the i-th device event.  Only
the host's launch times and the card's durations enter the tie: the
profiler lays the card's timestamps on the host's clock to within
tenths of a millisecond, so an event may read as starting before its
launch, and a few events at the window's start or end may read as
outside it and be missing.  So up to MAX_LOST launches at the ends may
go untied, and the tie is the one shift at which every event's kind
(kernel, copy, fill) agrees with its launch's; where there is no such
shift, or more than one, nothing is tied.  The first reader to ask
prints to standard error the window's device idle time by the innermost
program span at each moment (where the profile's breakdown says
"python"), with the idle time between calls, outside every root span,
in a row of its own, and the device time launched under each span.  Where the program keeps no spans (a program from before them),
every reader finds nothing and returns None."""

import bisect
import collections
import functools
import itertools
import sys

BETWEEN_CALLS = "(between calls)"
# the host calls that launch each kind of device event
_LAUNCH = {"kernel": "LaunchKernel", "gpu_memcpy": "Memcpy",
           "gpu_memset": "Memset"}
MAX_LOST = 64


def _program_spans():
    from tpuflow_torch.utils import trace

    read = getattr(trace, "spans", None)
    return read() if read else []


def level_of(span):
    """The pyramid level of a `level_<s>` span, else None."""
    name = span.name
    if name.startswith("level_") and name[6:].isdigit():
        return int(name[6:])
    return None


class Spans:
    """The program's spans of the traced calls and the device's busy
    time under them."""

    def __init__(self, record):
        tr = record.trace
        inside = [s for s in _program_spans()
                  if tr.start <= s.start and s.end <= tr.end]
        self.roots = [s for s in inside if s.parent is None]
        calls = {r.id for r in self.roots}
        self.spans = [s for s in inside if s.call in calls]
        self.start, self.end = tr.start, tr.end
        self.busy = tr.busy_intervals()
        self._ends = [t for _, t in self.busy]
        self.device_names = {name for _, _, name, *_ in tr.device}
        self.launched, self.untied, self.early_ns = self._tie(tr)

    @staticmethod
    def _tie(tr):
        """([(launch start, device ns)] in launch order, None, the most
        an event reads as starting before its launch) where each device
        event is tied to its launch; else ([], why, None)."""
        calls, last = [], None
        for start, end, name, kind in sorted(tr.host):
            if (kind != "runtime" or not tr.start <= start <= tr.end
                    or not any(k in name for k in _LAUNCH.values())):
                continue
            if last is not None and end <= last:
                continue    # a driver call inside the runtime call it serves
            calls.append((start, name))
            last = end
        lost = len(calls) - len(tr.device)
        wants = [_LAUNCH[kind] for *_, kind, _ in tr.device]
        fits = [k for k in range(lost + 1) if lost <= MAX_LOST and all(
            want in name for want, (_, name) in zip(wants, calls[k:]))]
        if len(fits) != 1:
            return [], (f"{len(calls)} launches on the calls' thread, "
                        f"{len(tr.device)} device events, {len(fits)} ways "
                        f"to tie them"), None
        calls = calls[fits[0]:]
        tied = [(t, e - s) for (t, _), (s, e, *_) in zip(calls, tr.device)]
        early = max((t - s for (t, _), (s, *_) in zip(calls, tr.device)),
                    default=0)
        return tied, None, max(early, 0)

    def launched_ns(self, a, b):
        """Device time of the events launched within [a, b]."""
        if not hasattr(self, "_sums"):
            self._starts = [t for t, _ in self.launched]
            self._sums = [0, *itertools.accumulate(d for _, d in self.launched)]
        i = bisect.bisect_left(self._starts, a)
        j = bisect.bisect_right(self._starts, b)
        return self._sums[j] - self._sums[i]

    def counter(self, name):
        """The counter `name` summed over the calls; None where no call
        counted it."""
        got = [r.counts[name] for r in self.roots if name in r.counts]
        return sum(got) if got else None

    def busy_ns(self, a, b):
        """Device busy time within [a, b]."""
        i = bisect.bisect_right(self._ends, a)
        total = 0
        while i < len(self.busy) and self.busy[i][0] < b:
            s, t = self.busy[i]
            total += min(t, b) - max(s, a)
            i += 1
        return total

    def coarse_levels(self):
        return [s for s in self.spans if (level_of(s) or 0) >= 1]

    def segments(self):
        """[(start, end, innermost span's name)] covering the window, in
        order; BETWEEN_CALLS outside every root span."""
        out, stack, t = [], [], self.start

        def upto(until):
            nonlocal t
            if until > t:
                out.append((t, until,
                            stack[-1].name if stack else BETWEEN_CALLS))
                t = until

        for s in sorted(self.spans, key=lambda s: (s.start, -s.end)):
            while stack and stack[-1].end <= s.start:
                upto(stack[-1].end)
                stack.pop()
            upto(s.start)
            stack.append(s)
        while stack:
            upto(stack[-1].end)
            stack.pop()
        upto(self.end)
        return out

    def idle_by_span(self):
        """{innermost span's name: device idle seconds} over the window."""
        idle = collections.Counter()
        for a, b, name in self.segments():
            idle[name] += (b - a - self.busy_ns(a, b)) * 1e-9
        return idle

    def report(self):
        idle = self.idle_by_span()
        total = sum(idle.values())
        print(f"flowbench: program spans: {len(self.roots)} calls, "
              f"{len(self.spans)} spans, {self.counter('spans.dropped') or 0} "
              f"dropped; device events named as a span: "
              f"{sorted(self.device_names & {s.name for s in self.spans})}",
              file=sys.stderr)
        launched = collections.Counter()
        for a, b, name in self.segments():
            launched[name] += self.launched_ns(a, b) * 1e-9
        print(f"flowbench: device idle {total:.6f} s of the window by the "
              f"innermost program span (then the device time launched "
              f"there):", file=sys.stderr)
        for name, seconds in idle.most_common():
            print(f"flowbench:   {name:<24} {seconds:.6f} s "
                  f"{100 * seconds / total if total else 0:6.2f}% "
                  f"{launched[name]:.6f} s", file=sys.stderr)
        levels = collections.defaultdict(lambda: [0, 0, 0])
        for s in self.spans:
            if level_of(s) is not None:
                got = levels[level_of(s)]
                got[0] += s.end - s.start
                got[1] += self.busy_ns(s.start, s.end)
                got[2] += self.launched_ns(s.start, s.end)
        print("flowbench: by level, s span-ms idle-ms launched-device-ms: "
              + ", ".join(f"{k} {1e-6 * span:.3f} {1e-6 * (span - busy):.3f} "
                          f"{1e-6 * dev:.3f}"
                          for k, (span, busy, dev) in sorted(levels.items())),
              file=sys.stderr)
        if self.untied:
            print(f"flowbench: device events not tied to launches: "
                  f"{self.untied}", file=sys.stderr)
        else:
            print(f"flowbench: {len(self.launched)} device events tied to "
                  f"their launches, the earliest read {self.early_ns} ns "
                  f"before it (the clocks' offset)", file=sys.stderr)


@functools.lru_cache(maxsize=1)
def spans_of(record):
    """The `Spans` of a traced run's record, built and reported once;
    None where the window holds no root span of the program."""
    view = Spans(record)
    if not view.roots:
        print("flowbench: the window holds no program spans", file=sys.stderr)
        return None
    view.report()
    return view
