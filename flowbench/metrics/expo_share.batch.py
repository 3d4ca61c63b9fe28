"""The share of the traced calls' device time, in %, that robust-expo's
diffusivity launched: the device time of the kernels, copies and fills
launched inside the program's `expo` spans (each level's gradient
magnitude, DF-AUTO's sort, percentile and lambda, and the exponential),
over that of those launched inside its root spans."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    expo = view and view.launched and [s for s in view.spans
                                       if s.name == "expo"]
    if not expo:
        return None
    calls = sum(view.launched_ns(r.start, r.end) for r in view.roots)
    return 100.0 * sum(view.launched_ns(s.start, s.end)
                       for s in expo) / calls
