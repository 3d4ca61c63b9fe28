"""K10's share of its roofline over the traced batch calls: each
launch's bytes at the card's peak rate (roofline/k10.py) over the
device time of `expo_terms_kernel`."""

from flowbench.metrics._common import roofline_share


def read(record):
    return roofline_share(record, "k10", "k10")
