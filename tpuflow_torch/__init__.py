"""tpuflow_torch — the PyTorch / CUDA port of tpuflow for one NVIDIA H100.

The JAX package `tpuflow` stays the reference; this package imports
neither it nor JAX.  Plain tensor code is PyTorch; each Pallas kernel
of the JAX package on a ported path becomes a CUDA C++ kernel for
sm_90a under `tpuflow_torch/csrc/`, built with nvcc at first use
(tpuflow_torch._build), with a plain PyTorch version beside it that
runs when the tensors lie on the CPU.

Ported so far: the batched TV-L1 engine `tvl1_batched`
(tpuflow_torch.models.batch).
"""

__version__ = "0.1.0"

from tpuflow_torch.models.batch import tvl1_batched

__all__ = ["tvl1_batched"]
