"""The plain references: the methods written out again in plain
PyTorch, batched over pairs, importing nothing of the port.  They
decide `correct` (flowbench.check) and serve as the control in a lower
precision (flowbench.control)."""
