"""Plain reference of `brox_spatial_batched`: the samples of a batch are
independent pairs, so it is reference/brox_spatial.py's `flow`, which
takes (B, ny, nx) stacks."""

from flowbench.reference.brox_spatial import flow  # noqa: F401
