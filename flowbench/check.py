"""The comparison that decides `correct`.

Every answer of the window is checked: each call's flow is reduced to a
fingerprint on the device (two float64 weighted sums), and every call
of one input must give the fingerprint of that input's last call, the
answer that is kept (the port is deterministic: equal inputs give equal
bits).  Once the window has closed, its peak memory has been read and
the program's state is freed, the plain reference
(`reference/<method>.py`) computes the flow of every input the window
used, from the same frames and nothing the program made, and each
field's mean endpoint error against it is held to two limits of the
configuration: the median over the fields (`epe_median`), and the share
of fields whose error exceeds `field_epe` (`fields_off_pct`).  Not the
largest field: the port's kernels sum each solve's error in another
order than PyTorch, so now and then a coarse level's solve stops an
iteration apart, and the levels above magnify that into one field's
error 1,000 times the others' (PERF.md).  The median stays put under
such a field; the share sees a fault in a minority of the fields that
the median cannot.  A batch is given to the reference whole, since the
engine's warp early exit is decided over the whole batch; a roster of
single pairs is given as one stack whose samples exit alone."""

import torch


def weights(ny, nx, device):
    """Fixed weights of the fingerprint: 1 + (pixel index mod 7919) / 7919."""
    idx = torch.arange(ny * nx, device=device, dtype=torch.float32)
    return (1 + torch.remainder(idx, 7919) / 7919).reshape(ny, nx)


def fingerprint(u, v, w):
    """(..., 2) float64 weighted sums of each field."""
    f64 = torch.float64
    return torch.stack([(u * w).sum(dim=(-2, -1), dtype=f64),
                        (v * w).sum(dim=(-2, -1), dtype=f64)], dim=-1)


def endpoint_error(u, v, ru, rv):
    """Each field's mean endpoint error, (B,)."""
    return torch.hypot(u - ru, v - rv).mean(dim=(-2, -1))


def median(epe):
    """The median of the fields' errors; of an even count, the mean of
    the two middle ones."""
    return float(torch.quantile(epe.double(), 0.5))


def off_pct(epe, field_epe):
    """The share of fields, in %, whose error exceeds `field_epe`."""
    return 100.0 * float((epe > field_epe).double().mean())


def judge(cell, inputs, kept, prints, order, w, raised):
    """Hold the window's answers to the reference and the limits.

    `inputs` (I0, I1) stacks; `kept[k]` the last (u, v) of input k;
    `prints[i]` call i's fingerprint and `order[i]` its input (None for
    a batch, whose input is the whole stack); `raised` the calls that
    raised.  Returns (correct, failed answers, checks): checks maps each
    number compared to {"value", "limit"}."""
    limits = cell.config["limits"]
    I0, I1 = inputs
    batch = order and order[0] is None
    per_call = I0.shape[0] if batch else 1
    mismatched = 0
    for f, k in zip(prints, order):
        u, v = kept[k]
        if not torch.equal(f, fingerprint(u, v, w)):
            mismatched += per_call
    keys = sorted(kept, key=lambda k: -1 if k is None else k)
    if batch:
        ref_in = (I0, I1)
    else:
        idx = torch.tensor(keys, device=I0.device)
        ref_in = (I0[idx], I1[idx])
    ru, rv = cell.reference.flow(*ref_in, cell.config["params"],
                                 joint_exit=bool(batch))
    u = torch.cat([kept[k][0].reshape(-1, *I0.shape[-2:]) for k in keys])
    v = torch.cat([kept[k][1].reshape(-1, *I0.shape[-2:]) for k in keys])
    epe = endpoint_error(u, v, ru, rv)
    checks = {
        "epe_median": {"value": median(epe),
                       "limit": limits["epe_median"]},
        "fields_off_pct": {"value": off_pct(epe, limits["field_epe"]),
                           "limit": limits["fields_off_pct"]},
        "repeat_mismatch": {"value": mismatched, "limit": 0},
        "raised": {"value": raised * per_call, "limit": 0},
    }
    failed = mismatched + raised * per_call
    correct = bool(prints) and all(c["value"] <= c["limit"]
                                   for c in checks.values())
    return correct, failed, checks
