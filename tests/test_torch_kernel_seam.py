"""The one seam between the solvers and the hand-written kernels.

Every kernel wrapper holds its inputs to `tpuflow_torch._device
.check_inputs` before it routes by `on_card`: a dtype, layout, shape or
device the kernel (on the CPU, its plain version) does not take raises
`KernelInputError`, which is both a TypeError and a ValueError, before
anything is launched or counted.  "meta" tensors stand in for the
card's: they pass the rule to the kernel's side, where the check refuses
every device but CUDA.  A wrapper with a stop returns err = inf and
n = 0 where there is nothing to run.
"""

import pytest
import torch

from tpuflow_torch._device import KernelInputError, on_card
from tpuflow_torch.ops.brox import brox_sor_error
from tpuflow_torch.ops.brox_terms import brox_terms, expo_terms
from tpuflow_torch.ops.hs import hs_sor_error
from tpuflow_torch.ops.hs_classic import hs_classic_fused
from tpuflow_torch.ops.pyramid_level import pyramid_level
from tpuflow_torch.ops.tvl1 import tvl1_iterate_error
from tpuflow_torch.ops.warp import (warp_const_batched, warp_const_hs_batched,
                                    warp_planes_batched,
                                    warp_planes_shift_batched, warp_planes_uv)
from tpuflow_torch.utils.trace import counters

B, NY, NX, P = 2, 9, 12, 4
PLANE = (B, NY, NX)


def _k(*shape):
    return (B, *shape, NY, NX)


# wrapper -> (call(tensors, max_iter), shapes of its tensors); max_iter is
# the wrapper's iteration bound where it has a stop
WRAPPERS = {
    "warp_const_batched": (
        lambda t, _: warp_const_batched(*t, 2), [_k(3), _k(2), PLANE]),
    "warp_const_hs_batched": (
        lambda t, _: warp_const_hs_batched(*t, 2, 0.5),
        [_k(3), _k(2), PLANE]),
    "warp_planes_batched": (
        lambda t, _: warp_planes_batched(*t, 2), [_k(P), _k(2)]),
    "warp_planes_shift_batched": (
        lambda t, _: warp_planes_shift_batched(*t, 2), [_k(P), _k(2)]),
    "warp_planes_uv": (
        lambda t, _: warp_planes_uv(*t, 2), [_k(P), PLANE, PLANE]),
    "tvl1_iterate_error": (
        lambda t, n: tvl1_iterate_error(*t, -1.0, n, 0.1, 0.3, 0.05),
        [_k(6), _k(4)]),
    "hs_sor_error": (
        lambda t, n: hs_sor_error(*t, -1.0, n, 0.5), [_k(2), _k(5)]),
    "hs_classic_fused": (
        lambda t, _: hs_classic_fused(*t, 0.5, 3), [PLANE, PLANE, PLANE]),
    "brox_sor_error": (
        lambda t, n: brox_sor_error(*t, -1.0, n, 0.5), [_k(2), _k(9)]),
    "brox_terms": (
        lambda t, _: brox_terms(*t, 0.5, 0.5, False),
        [PLANE] * 5 + [_k(6), _k(2), _k(9)]),
    "expo_terms": (
        lambda t, _: expo_terms(*t, 0.5, 0.5, False),
        [PLANE] * 6 + [_k(6), _k(2), _k(9)]),
    "pyramid_level": (
        lambda t, _: pyramid_level(tuple(t), (0.5, 0.25)), [PLANE, PLANE]),
}
STOPS = ("tvl1_iterate_error", "hs_sor_error", "brox_sor_error")


def _inputs(name, batch=B):
    torch.manual_seed(0)
    return [torch.rand((batch, *shape[1:])) for shape in WRAPPERS[name][1]]


def _strided(t):
    """`t` with its last two axes stored transposed: same values, not
    contiguous."""
    return t.transpose(-1, -2).contiguous().transpose(-1, -2)


# fault -> (change to the inputs, exception, message)
FAULTS = {
    "float64": (lambda t: t[:-1] + [t[-1].double()], TypeError, "float32"),
    "strided": (lambda t: [_strided(t[0])] + t[1:], ValueError,
                "contiguous"),
    "shape": (lambda t: t[:-1] + [t[-1][..., :-1].contiguous()], ValueError,
              "not"),
    "meta": (lambda t: [x.to("meta") for x in t], ValueError,
             "unsupported device|one CUDA device"),
}


def _faults(name):
    for fault in FAULTS:
        # warp_planes_uv and pyramid_level take any layout (they copy)
        if fault == "strided" and name in ("warp_planes_uv", "pyramid_level"):
            continue
        yield name, fault


@pytest.mark.parametrize("name,fault", [c for n in WRAPPERS
                                        for c in _faults(n)])
def test_the_check_refuses_before_any_launch(name, fault):
    call, _ = WRAPPERS[name]
    change, exc, match = FAULTS[fault]
    before = counters()
    with pytest.raises(exc, match=match) as info:
        call(change(_inputs(name)), 3)
    assert isinstance(info.value, KernelInputError)
    assert counters() == before


@pytest.mark.parametrize("name", ["warp_planes_uv", "pyramid_level"])
def test_layout_free_wrappers(name):
    """warp_planes_uv copies a strided input to the layout its kernel
    takes, so a strided input gives the contiguous one's result on the
    CPU; pyramid_level has no plain version, so a CPU input raises."""
    call, _ = WRAPPERS[name]
    inputs = _inputs(name)
    strided = [_strided(inputs[0])] + inputs[1:]
    before = counters()
    if name == "warp_planes_uv":
        assert torch.equal(call(strided, 3), call(inputs, 3))
    else:
        assert not on_card(inputs[0])
        with pytest.raises(ValueError, match="unsupported device cpu"):
            call(strided, 3)
    assert counters() == before


@pytest.mark.parametrize("name", STOPS)
@pytest.mark.parametrize("batch,max_iter", [(B, 0), (0, 5)])
def test_nothing_to_run(name, batch, max_iter):
    """Zero iterations, or an empty batch: err = inf, n = 0, the state as
    it was, and no iteration run or launched (the plain version reads its
    stop once, in `host_reads`)."""
    call, _ = WRAPPERS[name]
    inputs = _inputs(name, batch)
    state = inputs[0].clone()
    before = counters()
    out, err, n = call(inputs, max_iter)
    assert out is inputs[0] and torch.equal(out, state)
    assert err.shape == n.shape == (batch,)
    assert bool((err == float("inf")).all()) and bool((n == 0).all())
    moved = {k for k, v in counters().items() if v != before.get(k, 0)}
    assert moved <= {"host_reads"}
