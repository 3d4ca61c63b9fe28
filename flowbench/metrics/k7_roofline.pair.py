"""K7's share of its roofline over the traced pair calls: each solve's
bytes once, or its sweeps' operations, at the card's peaks, over the
device time of brox_sor_resident (roofline/k7.py)."""

from flowbench.metrics._common import roofline_share


def read(record):
    return roofline_share(record, "k7", "k7")
