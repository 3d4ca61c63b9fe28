"""The share of the traced calls' device time, in %, that the pyramid's
levels other than the finest launched: the device time of the kernels,
copies and fills launched inside the program's `level_<s>` spans,
s >= 1, over that of those launched inside its root spans."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    coarse = view and view.launched and view.coarse_levels()
    if not coarse:
        return None
    calls = sum(view.launched_ns(r.start, r.end) for r in view.roots)
    return 100.0 * sum(view.launched_ns(s.start, s.end)
                       for s in coarse) / calls
