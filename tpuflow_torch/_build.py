"""Build and load the CUDA kernels under `tpuflow_torch/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The build happens at first use, only ever from a wrapper that was
handed a CUDA tensor (the CPU path never needs `nvcc`).  Libraries go
to `build/tpuflow_torch/` beside the package, named by a hash of the
source, the shared headers (`csrc/*.cuh`) and the flags, so an edited
source rebuilds and an unchanged one loads at once.
`build_all()` starts one `nvcc` per source, all at the same time.
"""

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "tpuflow_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
KERNELS = ("warp_const", "warp_planes", "tvl1_iterate", "hs_sor",
           "hs_classic", "brox_sor", "pyramid", "brox_terms")

_loaded = {}


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME  # $CUDA_HOME, PATH, /usr/local/cuda

    if CUDA_HOME is None or not (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        raise RuntimeError("tpuflow_torch: nvcc not found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build_all(names=KERNELS, verbose=False):
    """Compile every library in `names` that is not built yet, one
    `nvcc` process per source, all started together.  Returns the
    {name: path} of the libraries; raises if any compile fails."""
    out = {}
    procs = []
    for name in names:
        src, lib = _target(name)
        out[name] = lib
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log:
            print(log, file=sys.stderr)
        os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    if failed:
        raise RuntimeError("tpuflow_torch: nvcc failed\n" + "\n".join(failed))
    return out


def load(name, signatures, geometry=None):
    """The ctypes handle of kernel library `name`, built on first use.

    `signatures` maps each C entry point to its argtypes; every entry
    point returns the `cudaError_t` of its launches as an int (or the
    int it documents).  `geometry`, (entry point, values), is the tile
    geometry the wrapper states: when the library loads, entry point
    `fn(k)` must give values[k] for every k, or this raises."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        if geometry is not None:
            fn, expected = geometry
            got = tuple(getattr(lib, fn)(k) for k in range(len(expected)))
            if got != tuple(expected):
                raise RuntimeError(f"tpuflow_torch: {fn} gives {got}, the "
                                   f"wrapper states {tuple(expected)}")
        _loaded[name] = lib
    return lib


def check(status, what):
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"tpuflow_torch: {what} failed with CUDA error "
                           f"{status}")
