"""Adapters to the port's public entry points, one module per method.

Each gives `call(I0, I1, params, device)`, the call that the window
times: (B, ny, nx) stacks go to the method's batched entry, single
(ny, nx) frames to its single-pair entry; and `work(I0, I1, params,
device)`, the same call through the port's own counters (`with_stats`,
`with_diag`), which the traced run reads after its window:
{"solver_iters": iterations or sweeps launched in the call, <kernel>:
the work that roofline/<kernel>.py takes, "launches": {<kernel>: its
expected launches}}."""
