"""The readings that the limits of `correct` are set from.

    python3 -m flowbench.control --workload <cell> --seeds 1,2,3 [--controls tf32,bf16]

For each seed: the cell's inputs; the program's answers, as the
window's calls give them (each input of the roster once, or the batch
once, after one warm-up call); the plain reference; and each control,
the reference in a lower precision put in the program's place
(reference/_ops.py: TF32 in the pyramid's products, or bfloat16).  One
JSON line per seed gives each side's `epe_median` and `fields_off_pct`,
the numbers the check compares, and for the record the fields' spread
and the largest endpoint error of any pixel.
A cell that BENCHMARK.json does not list yet is loaded from its
configuration's and its mix's files (`<config>.<traffic>`).  The
benchmark's own runs never run this."""

import argparse
import json
import sys
import time

import torch

from flowbench import check, harness, layout
from flowbench.reference import _ops


def readings(ref, answers, field_epe):
    """`answers` (u, v) against `ref`: `epe_median` and `fields_off_pct`,
    the numbers the check compares, and for the record the mean, the
    least and the largest eight of the fields' mean endpoint errors, the
    worst field, and the largest error of any pixel."""
    (u, v), (ru, rv) = answers, ref
    epe = check.endpoint_error(u, v, ru, rv)
    top = torch.sort(epe, descending=True)
    return {"epe_median": check.median(epe),
            "fields_off_pct": check.off_pct(epe, field_epe),
            "epe_mean": float(epe.mean()), "epe_min": float(epe.min()),
            "epe_top8": top.values[:8].tolist(), "worst": int(top.indices[0]),
            "epe_px_max": float(torch.hypot(u - ru, v - rv).amax())}


def iteration_flips(cell, inputs, dev, field):
    """For TV-L1: the warps at which the program's inner iterations
    (`tvl1_batched(with_stats=True)`, at B=1 for a single pair) differ
    from the reference's, for one field: [(scale, warp, program,
    reference)]."""
    import tpuflow_torch

    from flowbench.methods import tvl1

    I0, I1 = inputs
    params = cell.config["params"]
    batch = cell.traffic["kind"] == "batch"
    a, b = (I0, I1) if batch else (I0[field:field + 1], I1[field:field + 1])
    col = field if batch else 0
    _, _, stats = tpuflow_torch.tvl1_batched(
        a, b, device=dev.dev, with_stats=True,
        **tvl1._batch_kwargs(params, a.shape))
    counts = {}
    cell.reference.flow(a, b, params, joint_exit=batch, counts=counts)
    flips = []
    for scale, warps in stats["iterations"].items():
        ref = counts.get(scale, [])
        for w in range(max(len(warps), len(ref))):
            p = warps[w][col] if w < len(warps) else None
            r = ref[w][col] if w < len(ref) else None
            if p != r:
                flips.append((scale, w, p, r))
    return flips


def program_answers(cell, inputs, dev):
    I0, I1 = inputs
    params = cell.config["params"]
    if cell.traffic["kind"] == "batch":
        out = cell.method.call(I0, I1, params, dev.dev)
        dev.sync()
        return out
    us, vs = [], []
    for k in range(I0.shape[0]):
        u, v = cell.method.call(I0[k], I1[k], params, dev.dev)
        us.append(u)
        vs.append(v)
    dev.sync()
    return torch.stack(us), torch.stack(vs)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", default="tf32,bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = layout.Cell(layout.load_benchmark(), args.workload, unlisted=True)
    field_epe = cell.config["limits"]["field_epe"]
    dev = harness.Device(args.device)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        inputs = harness.make_inputs(cell, seed, dev.dev)
        if i == 0:
            program_answers(cell, inputs, dev)   # warm-up
        answers = program_answers(cell, inputs, dev)
        joint = cell.traffic["kind"] == "batch"
        params = cell.config["params"]
        ref = cell.reference.flow(*inputs, params, joint_exit=joint)
        line = {"workload": cell.name, "seed": seed, "device": dev.name(),
                "program": readings(ref, answers, field_epe)}
        if cell.config["method"] == "tvl1":
            line["program"]["flips"] = iteration_flips(
                cell, inputs, dev, line["program"]["worst"])
        for name in filter(None, args.controls.split(",")):
            line[name] = readings(ref, cell.reference.flow(
                *inputs, params, joint_exit=joint, prec=_ops.CONTROLS[name]),
                field_epe)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    sys.exit(main())
