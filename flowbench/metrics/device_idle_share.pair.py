"""The share of the traced window in which no kernel, copy or fill ran
on the card."""

from flowbench.metrics._common import idle_share


def read(record):
    return idle_share(record)
