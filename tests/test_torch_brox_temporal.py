"""The port's Brox temporal (`tpuflow_torch.brox_temporal`, its 3-D
gradient and its CLI) against the JAX package and the reference
binary's goldens (tests/goldens/brox_temporal.npz: 4 frames of 48x64).

JAX is run in exact mode only (each call computed once per test run);
on the CPU both packages then take the exact gather warp, and the 3-D
SOR is the same plain arithmetic on both sides, so the flows agree to
float32 rounding and the sweep counts to within one.  The port's fast
path (K5 / K5p at B = T-1, their plain versions here) is held against
the port's per-field warps, which tests/test_torch_brox_kernels.py and
tests/test_torch_warp_shift.py hold against JAX.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuflow.models.brox_temporal import brox_temporal as jax_brox_temporal
from tpuflow.ops.gradients import centered_gradient3 as jax_gradient3
from tpuflow_torch import brox_temporal
from tpuflow_torch.cli import brox_temporal as cli
from tpuflow_torch.io import read_flo, write_pfm
from tpuflow_torch.ops.gradients import centered_gradient3
from tpuflow_torch.ops.interp import K5_MIN_PIXELS, warp_by_mode, warp_planes_bounded
from tpuflow_torch.utils.convert import resume_from_jax

torch.set_num_threads(2)

# float32 on both sides, the same SOR arithmetic: the 48x64 flows agree
# to about 2e-5 (measured 1.7e-5 at one scale, 1.9e-6 at two)
EPE_JAX = 1e-4
# the reference binary's goldens, as tests/test_brox_temporal.py holds
# the JAX package to them (float64 at one scale, float32 at two)
EPE_GOLDEN = {1: 5e-3, 2: 1e-2}


def _epe(u, v, ru, rv):
    return float(np.mean(np.hypot(np.asarray(u) - np.asarray(ru),
                                  np.asarray(v) - np.asarray(rv))))


@pytest.fixture(scope="session")
def bt_vol():
    here = os.path.dirname(os.path.abspath(__file__))
    g = dict(np.load(os.path.join(here, "goldens", "brox_temporal.npz")))
    return g["vol"].astype(np.float32), g


@pytest.fixture(scope="session")
def jax_bt(bt_vol):
    """JAX `brox_temporal` (exact warp, float32) at one and two scales,
    with the diag and, at two scales, the level states."""
    vol, _ = bt_vol
    out = {}
    for ns in (1, 2):
        states = {}
        u, v, diags = jax_brox_temporal(
            jnp.asarray(vol), nscales=ns, clamp_scales=False,
            with_diag=True, warp_mode="exact",
            level_callback=lambda s, st: states.__setitem__(
                s, {k: np.asarray(a) for k, a in st.items()}))
        out[ns] = (np.asarray(u), np.asarray(v), diags, states)
    return out


@pytest.mark.parametrize("frames", [1, 4])
def test_centered_gradient3_matches_jax(frames):
    vol = np.random.default_rng(frames).standard_normal((frames, 9, 13))
    got = centered_gradient3(torch.from_numpy(vol))
    for g, j in zip(got, jax_gradient3(jnp.asarray(vol))):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)
    if frames == 1:
        assert not got[2].any()


@pytest.mark.parametrize("nscales", [1, 2])
def test_matches_jax_and_reference(bt_vol, jax_bt, nscales):
    vol, g = bt_vol
    ju, jv, jdiags, _ = jax_bt[nscales]
    u, v, diags = brox_temporal(vol, nscales=nscales, clamp_scales=False,
                                with_diag=True, device="cpu")
    assert u.dtype == torch.float32 and tuple(u.shape) == (3, 48, 64)
    assert _epe(u, v, ju, jv) <= EPE_JAX
    key = f"s{nscales}"
    assert _epe(u, v, g[f"{key}_u"], g[f"{key}_v"]) < EPE_GOLDEN[nscales]
    for d, jd in zip(diags, jdiags):
        its = d["iterations"].numpy()
        assert its.shape == (15, 1)
        assert np.all(np.abs(its - np.asarray(jd["iterations"])) <= 1)
        # one host read after each sweep of stop="error"
        assert d["host_reads"] == int(its.sum())


def test_needs_three_frames(bt_vol):
    with pytest.raises(ValueError, match="more than two frames"):
        brox_temporal(bt_vol[0][:2], device="cpu")


def test_no_silent_cpu_fallback(bt_vol, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        brox_temporal(bt_vol[0], nscales=1)


@pytest.mark.parametrize("ny,nx", [(96, 128), (48, 64)])
def test_batched_fast_warp_equals_per_field_warps(ny, nx):
    """The fast path's one warp of the (T-1, 6, H, W) stack (K5 at
    >= 96x96 px, K5p below) equals warping each field's stack alone,
    past the bound too."""
    rng = np.random.default_rng(ny)
    planes = torch.from_numpy(rng.standard_normal((3, 6, ny, nx)).astype(np.float32))
    u, v = (torch.from_numpy(5 * rng.standard_normal((3, ny, nx)).astype(np.float32))
            for _ in range(2))
    assert (ny * nx >= K5_MIN_PIXELS) == (ny == 96)
    got = warp_by_mode(planes, u, v, "fast", 4)
    want = torch.stack([warp_planes_bounded(p, a, b, 4)
                        for p, a, b in zip(planes, u, v)])
    assert torch.equal(got, want)
    assert got.abs().sum() > 0


def test_fast_warp_close_to_exact(bt_vol):
    """The fast route (K5p's plain version at 48x64) against the exact
    gather, as tests/test_brox_temporal.py holds the JAX package."""
    vol, _ = bt_vol
    u_e, v_e = brox_temporal(vol, nscales=2, clamp_scales=False,
                             warp_mode="exact", device="cpu")
    u_f, v_f = brox_temporal(vol, nscales=2, clamp_scales=False,
                             warp_mode="fast", device="cpu")
    assert _epe(u_f, v_f, u_e, v_e) < 2e-3


def test_resume_from_jax_level_state(bt_vol, jax_bt):
    """JAX's level-1 state {"u1", "u2"} (T-1, 36, 48) carried across:
    the port finishes level 0 as JAX does."""
    vol, _ = bt_vol
    ju, jv, _, states = jax_bt[2]
    assert sorted(states) == [0, 1] and states[1]["u1"].shape == (3, 36, 48)
    resume = resume_from_jax(1, states[1], device="cpu")
    seen = []
    u, v = brox_temporal(vol, nscales=2, clamp_scales=False, resume=resume,
                         level_callback=lambda s, st: seen.append(s),
                         device="cpu")
    assert seen == [0]
    assert _epe(u, v, ju, jv) <= EPE_JAX


def test_cli_writes_each_field(bt_vol, tmp_path, capsys):
    vol, _ = bt_vol
    paths = []
    for k, frame in enumerate(vol):
        paths.append(str(tmp_path / f"f{k}.pfm"))
        write_pfm(paths[-1], frame)
    out = tmp_path / "out"
    out.mkdir()
    rc = cli.main(["4", *paths, "18", "7", "2", "0.75", "0.0001", "1", "15",
                   str(out), "1"], device="cpu")
    assert rc == 0
    assert sorted(os.listdir(out)) == ["flow00.flo", "flow01.flo", "flow02.flo"]
    u, v = brox_temporal(vol, nscales=2, device="cpu")
    for k in range(3):
        fu, fv = read_flo(str(out / f"flow{k:02d}.flo"))
        np.testing.assert_allclose(fu, u[k].numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(fv, v[k].numpy(), rtol=0, atol=1e-5)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == (" alpha:18 gamma:7 scales:2 nu:0.75 TOL:0.0001 "
                        "inner:1 outer:15")
    assert [x for x in lines if x.startswith("Scale")] == ["Scale: 1", "Scale: 0"]
    assert sum(bool(re.fullmatch(r"Iterations: \d+", x)) for x in lines) == 30
    # frames of unequal size are refused
    write_pfm(paths[-1], vol[-1][:, :32])
    assert cli.main(["4", *paths, "18", "7", "2", "0.75", "0.0001", "1", "15",
                     str(out), "0"], device="cpu") == 1
