"""Solver work launched per call, from the port's own counters: TV-L1's
inner iterations launched (K2 runs them in chunks of 16 until the host
reads that every sample stopped), or Brox's SOR sweeps (K7 stops on the
device).  It shows whether the work of a call varies with the seed."""


def read(record):
    if not record.work:
        return None
    return sum(w["solver_iters"] for w in record.work) / len(record.work)
