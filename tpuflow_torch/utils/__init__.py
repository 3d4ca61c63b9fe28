"""Checkpoints, warm-up, tracing and state carry-across helpers."""

from tpuflow_torch.utils.checkpoint import (load_level_checkpoint,
                                            save_level_checkpoint)
from tpuflow_torch.utils.trace import trace_scope
