"""Timing and tracing (port of `opticalflowclustering_tpu/utils/profiling.py`).

Per-stage wall timers that wait for the card, a frames/sec meter, the
port's named spans (`span`, `spanned`), a `torch.profiler` trace context,
and the card-side timers the probe scripts use: CUDA events around one call,
the slope between two trip counts, which cancels the launch, and the replay
of a CUDA graph of many launches, which leaves the host out of a small
kernel's time.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import subprocess
import time
from collections import defaultdict
from collections.abc import Callable

import torch
import torch.autograd.profiler

# Published peaks of one H100 SXM (NVIDIA's data sheet, at its 700 W power
# limit): HBM3 at 3.35 TB/s, and 67 TFLOP/s in float32 outside the tensor
# cores, which counts a multiply-add as two: 33.5 T adds or multiplies/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time in ms an H100 could take to move `nbytes` through its
    memory and do `ops` float32 operations, and which of the two sets it,
    "bytes" or "operations"."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class StageTimer:
    """Accumulates per-stage wall time, waiting for the card where asked."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time the block. `sync`, a tensor, names the device to wait for
        before the clock stops: a CUDA tensor synchronizes its device, a CPU
        tensor (or None) waits for nothing."""
        t0 = time.perf_counter()
        yield
        if sync is not None and sync.is_cuda:
            torch.cuda.synchronize(sync.device)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name}: {total * 1e3:.1f} ms total, "
                         f"{total / n * 1e3:.2f} ms/call ({n} calls)")
        return "\n".join(lines)


class ThroughputMeter:
    """frames/sec meter — `imutils.FPS` equivalent
    (`real_time_object_detection.py:31,67-71`) for batched pipelines."""

    def __init__(self):
        self._start = None
        self._frames = 0

    def start(self):
        self._start = time.perf_counter()
        self._frames = 0
        return self

    def update(self, n_frames: int = 1):
        self._frames += n_frames

    def elapsed(self) -> float:
        return time.perf_counter() - self._start

    def fps(self) -> float:
        e = self.elapsed()
        return self._frames / e if e > 0 else 0.0


_OFF = contextlib.nullcontext()


def span(name: str):
    """A named span of the port's pipeline (`ofc.<stage>`) on the profiler's
    host clock: `with span("ofc.stack"): ...`. While a `torch.profiler`
    profile is running, in any thread, it is a `record_function` span, so
    the profiler's trace holds its name, start and end on the clock it maps
    the card's kernels and copies onto; otherwise it is one shared
    `nullcontext` and costs a flag read. It never waits for a device and is
    never held open across a `yield`. A span opened on a thread the port
    started reaches the trace only where the profile takes every thread
    (`trace_to`)."""
    return torch.profiler.record_function(name) if torch.autograd.profiler._is_profiler_enabled else _OFF


def spanned(name: str):
    """Decorator: each call of the function in one `span(name)`, the span
    of an entry (`ofc.process_frames`) that its stages' spans nest in."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


@contextlib.contextmanager
def trace_to(logdir: str):
    """torch.profiler trace context: `with trace_to('traces') as prof:
    run()` profiles the CPU and, where there is one, the card, and writes
    `<logdir>/trace.json` (Chrome trace format) on exit; `prof.key_averages()`
    sums the time by operator. Every thread is profiled, so the trace also
    holds the decode threads' `ofc.decode` spans."""
    from torch._C._profiler import _ExperimentalConfig

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def card_line(index: int = 0) -> str:
    """Card `index`'s name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def sm_clocks_mhz(index: int = 0) -> tuple[float, float]:
    """Card `index`'s SM clock now and its maximum in MHz, as `nvidia-smi
    --query-gpu=clocks.sm,clocks.max.sm` prints them."""
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    sm, max_sm = (float(c) for c in out.split(","))
    return sm, max_sm


def event_ms(fn: Callable[[], object], repeats: int = 10, warmup: int = 1) -> float:
    """Least time in ms of one call of `fn` over `repeats` calls, between CUDA
    events recorded on the current stream around it (after `warmup` calls).
    Raises where there is no CUDA device: it times the card only."""
    if not torch.cuda.is_available():
        raise RuntimeError("event_ms times the card, but torch.cuda.is_available() is False")
    for _ in range(warmup):
        fn()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def slope_ms(
    fn_of: Callable[[int], Callable[[], object]], lo: int, hi: int, repeats: int = 10
) -> float:
    """(t(hi) − t(lo)) / (hi − lo) in ms, where t(k) is `event_ms` of
    `fn_of(k)`: the cost of one more unit of work with the launch cancelled.
    Raises if t(hi) is not at least 1.5 × t(lo), which is what a loop that
    the compiler hoisted or folded looks like."""
    t_lo = event_ms(fn_of(lo), repeats)
    t_hi = event_ms(fn_of(hi), repeats)
    if not t_hi >= 1.5 * t_lo:
        raise RuntimeError(
            f"time does not grow with the work: t({hi}) = {t_hi:.6g} ms, "
            f"t({lo}) = {t_lo:.6g} ms (loop hoisted or folded?)"
        )
    return (t_hi - t_lo) / (hi - lo)


def graph_ms(fn: Callable[[], object], launches: int = 200, repeats: int = 10) -> float:
    """Least device time in ms of one call of `fn`: `launches` calls are
    captured into one CUDA graph, and each of `repeats` replays is timed
    between CUDA events on the current stream and divided by `launches`.
    The host's work per call (checks, allocation, the enqueue) runs once, at
    capture, so this times the kernels and the gaps between them. `fn` runs
    once first on a side stream, as capture requires. Raises where there is
    no CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_ms times the card, but torch.cuda.is_available() is False")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    best = math.inf
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / launches)
    return best
