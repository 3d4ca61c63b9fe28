"""The share of the coarse levels' time, in %, in which no kernel, copy
or fill ran on the card: device idle time inside the program's
`level_<s>` spans, s >= 1, over their time."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    coarse = view and view.coarse_levels()
    if not coarse or not record.trace.device:
        return None
    span = sum(s.end - s.start for s in coarse)
    busy = sum(view.busy_ns(s.start, s.end) for s in coarse)
    return 100.0 * (span - busy) / span
