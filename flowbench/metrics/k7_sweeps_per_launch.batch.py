"""K7 sweeps a launch of route "stream", as the program counts them
(`iters.k7` over `launches.k7`, both summed over the calls' root spans):
the depth at which the stream kernel ran its sweeps, 1 where each launch
runs one.  None where the program counts no `launches.k7`."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    launches = view and view.counter("launches.k7")
    if not launches:
        return None
    return (view.counter("iters.k7") or 0) / launches
