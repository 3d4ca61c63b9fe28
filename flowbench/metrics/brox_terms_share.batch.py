"""The share of the traced calls' device time, in %, that the Brox
system's plain ops launched: the device time of the kernels, copies and
fills launched inside the program's `terms` spans (the smoothness
weights, the weighted divergences, the data terms and the stacking of
K7's state and constants), over that of those launched inside its root
spans."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    terms = view and view.launched and [s for s in view.spans
                                        if s.name == "terms"]
    if not terms:
        return None
    calls = sum(view.launched_ns(r.start, r.end) for r in view.roots)
    return 100.0 * sum(view.launched_ns(s.start, s.end)
                       for s in terms) / calls
