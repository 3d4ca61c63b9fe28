"""K7's share of its roofline over the traced batch calls: each sample's
solves, their bytes once or their sweeps' operations at the card's
peaks, over the device time of both routes' kernels (roofline/k7_batch.py)."""

from flowbench.metrics._common import roofline_share


def read(record):
    return roofline_share(record, "k7_batch", "k7_batch")
