"""Host reads of a device value per traced call, as the program counts
them (`host_reads` over the calls' root spans): one a warp for the warp
early exit, and one after each chunk of iterations or sweeps where a
solve's stop is read on the host (K2, K4's route "tiles")."""

from flowbench.metrics._spans import spans_of


def read(record):
    view = spans_of(record)
    reads = view and view.counter("host_reads")
    return None if reads is None else reads / len(view.roots)
