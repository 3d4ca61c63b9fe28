"""Build and load the CUDA kernels under `tpuflow_torch/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into a shared
library with a plain C interface and loaded with `ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The build happens at first use, only ever from a wrapper that was
handed a CUDA tensor (the CPU path never needs `nvcc`).  Every wrapper
calls its entry points through `launch`.  Libraries go
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

import torch

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


def launch(lib, entry, *args, device, stream=True):
    """Call C entry point `entry` of library `lib` on CUDA device
    `device` (a torch.device): a tensor passes as its data_ptr(), None as
    a null pointer, anything else as it is, and the device's current
    stream last (unless not `stream`: an entry that launches nothing).
    Raises if the entry returns a CUDA error code.  The stream is read as
    PyTorch's compiled code reads it for its own launches, without a
    Python stream object: this runs on every launch."""
    args = [a.data_ptr() if type(a) is torch.Tensor else a for a in args]
    with torch.cuda.device(device):
        if stream:
            args.append(torch._C._cuda_getCurrentRawStream(device.index))
        status = getattr(lib, entry)(*args)
    if status != 0:
        raise RuntimeError(f"tpuflow_torch: {entry} failed with CUDA error "
                           f"{status}")
