"""The program's own tracing: spans and counters.

Counters.  `count(name, k=1)` adds `k` to a process-wide counter, on
every call (a lock and a dict update); `counters()` returns a copy of
them all.  Names say what they count:

  host_reads        host reads of a device value: the decisions to stop
                    a solve or a level's warp loop, and the values the
                    verbose solvers print
  iters.k2, iters.k7
                    K2 iterations and K7 sweeps (route "stream")
                    launched; on the CPU, the iterations K2's plain
                    version ran
  launches.k1, launches.k3, launches.k7
                    K1 and K3 launches, and K7's route "stream" sweep
                    launches (each of 1 or DEEP_K sweeps)
  calls.<wrapper>[.<route or group>]
                    calls of a kernel wrapper that launched its kernel
                    (`calls.tvl1_iterate_error`, `calls.hs_sor_error`,
                    `calls.hs_classic_fused`,
                    `calls.brox_sor_error.{resident,stream}`,
                    `calls.brox_terms`,
                    `calls.warp_planes[_shift]_batched.g{6,3}`, the
                    planes a thread warps)
  spans.dropped     spans pushed out of the full buffer

Spans.  `span(name)` is a context manager that keeps a `Span` when it
closes: its name, its start and end in ns of `time.time_ns()` (the
clock of `torch.profiler`'s host events, so a span lies among them),
the id of its parent span (None for a call's outermost span) and the id
of its call (the outermost span's id); a call's outermost span also
keeps the deltas of the counters over its life.  Spans are kept only while `recording()` is open or a
`torch.profiler.profile` / `torch.autograd.profiler.profile` session
records; otherwise `span` returns one shared no-op context (a flag test
and no allocation).  The buffer keeps the newest MAX_SPANS spans;
`spans()` returns them, oldest first, and `clear()` empties it.

Spans never call `torch.profiler.record_function`: the profiler mirrors
a record_function range that encloses work on the card as a device
event, which a reader of the trace would take for a kernel.  Inside
`recording()` on a machine with a card each span is also an NVTX range,
so Nsight Systems draws the spans beside the kernels:

    with tpuflow_torch.utils.trace.recording():
        tpuflow_torch.tvl1_batched(I0, I1)
    # run under `nsys profile python3 script.py`

The JAX package's `start_server` (an on-demand XProf profiler server)
has no PyTorch counterpart; trace a call with `torch.profiler` instead.
Nor is there a compile cache to configure (the JAX package's
`utils/cache.py` and the CLIs' `enable_persistent_cache`): the kernels'
libraries are built once into `build/tpuflow_torch/`, named by a hash of
their sources, and that directory is the cache.
"""

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _profiler

MAX_SPANS = 100_000

_lock = threading.Lock()
_counters = {}
_kept = collections.deque(maxlen=MAX_SPANS)   # Span fields as tuples
_ids = itertools.count(1)
_open = threading.local()   # .stack: this thread's open spans
_recording = 0              # depth of open `recording()` blocks
_nvtx = False               # spans push NVTX ranges
_NO_SPAN = contextlib.nullcontext()


class Span(NamedTuple):
    id: int
    name: str
    start: int               # ns, time.time_ns()
    end: int
    parent: Optional[int]    # None for a call's outermost span
    call: int                # the outermost span's id
    counts: Optional[dict]   # a root's counter -> delta; None below it


def count(name, k=1):
    """Add `k` to the counter `name`."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + k


def counters():
    """A copy of every counter: {name: count}."""
    with _lock:
        return dict(_counters)


def spans():
    """The kept spans, oldest first."""
    return [Span(*fields) for fields in list(_kept)]


def clear():
    """Empty the buffer of kept spans (the counters stay)."""
    _kept.clear()


class _Recorded:
    # kept cheap: on the card the host's time after a read of the device
    # is the device's idle time.  A span below the root takes two clock
    # reads and one append; a root also snapshots the counters.
    __slots__ = ("name", "id", "parent", "call", "start", "base", "nvtx")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        try:
            stack = _open.stack
        except AttributeError:
            stack = _open.stack = []
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            # a dict's copy holds the interpreter lock throughout: no
            # `count` runs inside it
            self.parent, self.call, self.base = None, self.id, _counters.copy()
        stack.append(self)
        self.nvtx = _nvtx
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        _open.stack.pop()
        deltas = None
        if self.parent is None:
            base = self.base
            deltas = {k: v - base.get(k, 0) for k, v in _counters.copy().items()
                      if v != base.get(k, 0)}
        if len(_kept) == _kept.maxlen:
            count("spans.dropped")
        _kept.append((self.id, self.name, self.start, end, self.parent,
                      self.call, deltas))
        return False


def span(name):
    """A span `name` around the block it opens, kept while recording or
    profiling (see the module's note)."""
    if _recording or _profiler._is_profiler_enabled:
        return _Recorded(name)
    return _NO_SPAN


# the JAX package's name for a named scope around a solver phase
trace_scope = span


def traced(fn):
    """`fn` with each call in a span named after it: a public entry's
    root span, which counts its inputs' move to the device too."""
    name = fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return call


@contextlib.contextmanager
def recording():
    """Keep spans inside the block, profiler or not; on a machine with
    a card each span is also an NVTX range there."""
    global _recording, _nvtx
    on_card = torch.cuda.is_available()
    with _lock:
        _recording += 1
        _nvtx = on_card
    try:
        yield
    finally:
        with _lock:
            _recording -= 1
            if not _recording:
                _nvtx = False
