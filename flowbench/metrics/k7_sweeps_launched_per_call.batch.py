"""K7 sweeps launched per traced call, as the program counts them at
each launch of route "stream" (`iters.k7` over the calls' root spans):
the sweeps the slowest sample of each solve needed, rounded up to the
chunks between two host reads.  Route "resident" launches no sweep the
host counts."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    sweeps = view and view.counter("iters.k7")
    return None if sweeps is None else sweeps / len(view.roots)
