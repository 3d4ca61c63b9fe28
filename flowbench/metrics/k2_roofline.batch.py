"""K2's share of its roofline over the traced batch calls: the bytes of
the iterations the samples needed, at each level, counted once at the
card's memory rate, over the device time of tvl1_primal, tvl1_dual and
stop_finalize (roofline/k2.py)."""

from flowbench.metrics._common import roofline_share


def read(record):
    return roofline_share(record, "k2", "k2")
