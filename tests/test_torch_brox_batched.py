"""`brox_spatial_batched` on the CPU: each sample is `brox_spatial` of its
pair, bit for bit; the batch agrees with the benchmark's plain reference
(flowbench/reference/brox_spatial.py); each sample's SOR solves stop on
their own; a call keeps the spans the benchmark's readers take.

At 64x96 (three pyramid levels), B = 2, on the plain versions of the
kernels.  The float32 batch runs at the reference CLI's defaults; the
float64 one with 5 outer iterations, which is enough to hold every
level's code and keeps the file cheap."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flowbench.reference import brox_spatial as reference
from tpuflow_torch import brox_spatial, brox_spatial_batched
from tpuflow_torch.data import synth_pair
from tpuflow_torch.utils.trace import recording, spans

NY, NX = 64, 96
CONFIG = Path(__file__).resolve().parent.parent / "flowbench" / "configs" / \
    "brox-batched-sintel.json"


def _sweeps(diags):
    """{scale: per-solve lists of one sample's sweeps} of a pair call."""
    return {s: d["iterations"].reshape(-1).tolist()
            for s, d in enumerate(diags)}


def _of_sample(stats, b):
    return {s: [per[b] for per in solves]
            for s, solves in stats["iterations"].items()}


@pytest.fixture(scope="module")
def still_and_moving():
    """A float32 batch of a still pair (I0, I0) and a moving one, at the
    CLI defaults and the cell's bounded warp, called under
    `recording()`; and each pair alone."""
    I0, I1 = synth_pair(NY, NX, seed=0)
    a, b = np.stack([I0, I0]), np.stack([I0, I1])
    with recording():
        before = {s.id for s in spans()}
        u, v, stats = brox_spatial_batched(a, b, with_stats=True,
                                           warp_mode="fast", device="cpu")
        kept = [s for s in spans() if s.id not in before]
    pairs = [brox_spatial(a[k], b[k], with_diag=True, warp_mode="fast",
                          device="cpu") for k in range(2)]
    return a, b, (u, v, stats), pairs, kept


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_each_sample_is_its_pair_bit_for_bit(dtype, still_and_moving):
    if dtype == torch.float32:
        _, _, (u, v, stats), pairs, _ = still_and_moving
        kw = {}
    else:
        a, b = (np.stack(x).astype(np.float64)
                for x in zip(*(synth_pair(NY, NX, seed=k) for k in (1, 2))))
        kw = {"outer_iter": 5}
        u, v, stats = brox_spatial_batched(a, b, with_stats=True,
                                           device="cpu", **kw)
        pairs = [brox_spatial(a[k], b[k], with_diag=True, device="cpu", **kw)
                 for k in range(2)]
    assert u.dtype == dtype and tuple(u.shape) == (2, NY, NX)
    for k, (pu, pv, diags) in enumerate(pairs):
        assert torch.equal(u[k], pu) and torch.equal(v[k], pv), k
        assert _of_sample(stats, k) == _sweeps(diags), k


def test_the_batch_agrees_with_the_plain_reference(still_and_moving):
    """Within the limits that decide the cell's `correct` on the card
    (flowbench/configs/brox-batched-sintel.json): on the CPU the port's
    plain versions and the reference compute the same float32
    arithmetic, so each field lies far inside them, and a fault of the
    batching (a sample's flow, stop or pyramid mixed with another's)
    lies far outside."""
    a, b, (u, v, _), _, _ = still_and_moving
    config = json.loads(CONFIG.read_text())
    ru, rv = reference.flow(torch.as_tensor(a), torch.as_tensor(b),
                            config["params"])
    epe = torch.hypot(u - ru, v - rv).mean(dim=(-2, -1))
    assert float(epe.max()) <= config["limits"]["field_epe"], epe.tolist()


def test_each_sample_stops_on_its_own(still_and_moving):
    """The still pair's solves stop after a sweep while the moving
    pair's run on; each sample's counts are its pair call's."""
    _, _, (_, _, stats), pairs, _ = still_and_moving
    still, moving = (_of_sample(stats, k) for k in range(2))
    assert still == _sweeps(pairs[0][2]) and moving == _sweeps(pairs[1][2])
    assert set(still) == set(moving) == {0, 1, 2}
    assert all(n == 1 for solves in still.values() for n in solves)
    assert all(max(solves) > 1 for solves in moving.values())


def test_a_call_keeps_the_spans_of_its_layers(still_and_moving):
    """One root span, the pyramid's spans, and per outer iteration of each
    level one `warp`, two `terms` (smoothness, then the data terms and
    the system) and one `solve` (a K7 call), all inside the root."""
    *_, kept = still_and_moving
    roots = [s for s in kept if s.parent is None]
    assert [r.name for r in roots] == ["brox_spatial_batched"]
    names = [s.name for s in kept if s.call == roots[0].id]
    levels = 3
    for name, want in (("warp", 15 * levels), ("terms", 30 * levels),
                       ("solve", 15 * levels), ("prepare", 1),
                       ("upsample", levels - 1)):
        assert names.count(name) == want, name
    assert {n for n in names if n.startswith("level_")} == {
        f"level_{s}" for s in range(levels)}
