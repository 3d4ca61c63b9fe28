"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `tpuflow_torch`.  With
`--trace 0` the last line of standard output carries the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics and the
trace's breakdown; the numbers that decided `correct` come last there
and as the last lines of standard error.  The run exits with 2 and
prints no result where there is no card, or fewer than the cell asks
for, and with 3 where a module of JAX or of the JAX package `tpuflow`
was loaded.  Caches of the toolchains and of Python's bytecode go to
`build/flowbench/` in the checkout; the port builds its kernels into
`build/tpuflow_torch/`.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "tpuflow"}


def forbidden_modules():
    """Top-level names of loaded modules that this process may not hold,
    compared whole (`tpuflow_torch` is not `tpuflow`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    cache = ROOT / "build" / "flowbench"
    # Python's own bytecode cache: where the interpreter may not write
    # beside the installed packages, every run would compile torch anew
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(cache / "pyc")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda_cache")

    import torch

    from flowbench import harness, layout

    cell = layout.Cell(layout.load_benchmark(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"flowbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import tpuflow_torch

    if not Path(tpuflow_torch.__file__).resolve().is_relative_to(ROOT):
        print(f"flowbench: tpuflow_torch comes from {tpuflow_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, args.trace, "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"flowbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
