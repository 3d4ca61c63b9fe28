"""TV-L1 constants and the reference-shaped inner step.

`_inner_step` is one TV-L1 fixed-point iteration written as the
reference writes it (src/tvl1flow.cpp:113-181): fi = -rho/grad, hypot,
a division by (1 + taut*|grad u|), and the per-image MEAN of the
squared update.  The engine never calls it (it runs the kernel's
arithmetic, `tpuflow_torch.ops.tvl1`); the tests use it as an
independent reference for that arithmetic.
"""

import torch

from tpuflow_torch.ops.gradients import divergence, forward_gradient

MAX_ITERATIONS = 300  # reference src/tvl1flow.cpp:22
GRAD_IS_ZERO = 1e-10  # reference src/tvl1flow.cpp:24

# CLI defaults, reference src/tvl1flow_main.cpp:24-33
DEFAULT_TAU = 0.25
DEFAULT_LAMBDA = 0.15
DEFAULT_THETA = 0.3
DEFAULT_NSCALES = 100
DEFAULT_ZFACTOR = 0.5
DEFAULT_WARPS = 5
DEFAULT_EPSILON = 0.01


def _inner_step(u1, u2, p11, p12, p21, p22, I1wx, I1wy, rho_c, grad,
                l_t, theta, taut):
    """One TV-L1 fixed-point iteration (reference src/tvl1flow.cpp:113-181)."""
    rho = rho_c + I1wx * u1 + I1wy * u2
    fi = -rho / torch.clamp(grad, min=GRAD_IS_ZERO)
    lo = rho < -l_t * grad
    hi = rho > l_t * grad
    tiny = grad < GRAD_IS_ZERO
    zero = torch.zeros_like(rho)
    d1 = torch.where(lo, l_t * I1wx, torch.where(
        hi, -l_t * I1wx, torch.where(tiny, zero, fi * I1wx)))
    d2 = torch.where(lo, l_t * I1wy, torch.where(
        hi, -l_t * I1wy, torch.where(tiny, zero, fi * I1wy)))
    u1_new = u1 + d1 + theta * divergence(p11, p12)
    u2_new = u2 + d2 + theta * divergence(p21, p22)
    error = torch.mean((u1_new - u1) ** 2 + (u2_new - u2) ** 2)
    u1x, u1y = forward_gradient(u1_new)
    u2x, u2y = forward_gradient(u2_new)
    ng1 = 1.0 + taut * torch.hypot(u1x, u1y)
    ng2 = 1.0 + taut * torch.hypot(u2x, u2y)
    return (u1_new, u2_new, (p11 + taut * u1x) / ng1, (p12 + taut * u1y) / ng1,
            (p21 + taut * u2x) / ng2, (p22 + taut * u2y) / ng2, error)
