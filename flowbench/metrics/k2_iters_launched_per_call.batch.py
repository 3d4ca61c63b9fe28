"""K2 iterations launched per traced call, as the program counts them
at each launch (`iters.k2` over the calls' root spans): the iterations
the slowest sample of each warp needed, rounded up to the chunks
between two host reads."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    iters = view and view.counter("iters.k2")
    return None if iters is None else iters / len(view.roots)
