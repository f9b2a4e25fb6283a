"""The traced run: `torch.profiler` over a few steady requests, reduced to
what the per-layer metrics read.

The harness marks the traced window with a `record_function` span
("ofc_bench.window") and each request with another ("ofc_bench.request");
the profiler's Chrome trace gives the device's kernels, copies and fills
(CUPTI) on the host's clock, and the host's operators and runtime calls.
`TraceView` holds those that fall in the window; each metric's reader
(`metrics/<name>.py`) takes what it needs from it.
"""

from __future__ import annotations

import collections
import dataclasses
import re

WINDOW = "ofc_bench.window"
REQUEST = "ofc_bench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


@dataclasses.dataclass
class Event:
    name: str
    cat: str
    start: float  # µs on the host's clock
    end: float
    device: int | None
    tid: int
    args: dict

    @property
    def dur(self) -> float:
        return self.end - self.start


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(event: "Event") -> str:
    """A device operation's name: a kernel's without `void `, `(anonymous
    namespace)::` or its parameter list; a copy's or fill's as it stands."""
    if event.cat != "kernel":
        return event.name
    name = re.sub(r"^void ", "", event.name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):  # the parameter list opens at depth 0, after the template
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i][:120]
    return name[:120]


class TraceView:
    """The traced window: device events per card and host events of the
    thread that drove the requests, clipped to the window, and the host-clock
    latency of each clip that the window's requests finished (`clip_ms`)."""

    def __init__(self, trace: dict, *, pairs: int, config: dict, devices: list[int], peak_alloc_bytes: int | None,
                 clip_ms: list[float] = ()):
        self.pairs, self.config, self.devices = pairs, config, devices
        self.peak_alloc_bytes = peak_alloc_bytes
        self.clip_ms = list(clip_ms)
        events = []
        for e in trace.get("traceEvents", []):
            if e.get("ph") != "X" or "dur" not in e:
                continue
            dev = None
            if e.get("cat") in DEVICE_CATS:
                dev = int(e.get("args", {}).get("device", e.get("pid")))
            events.append(Event(e["name"], e.get("cat", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                                dev, e.get("tid", 0), e.get("args", {})))
        windows = [e for e in events if e.name == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"the trace holds {len(windows)} '{WINDOW}' spans, not 1")
        w = windows[0]
        self.t0, self.t1, self.host_tid = w.start, w.end, w.tid

        def inside(e):
            return e.end > self.t0 and e.start < self.t1

        self.device_events = [e for e in events if e.device is not None and inside(e)]
        self.host_events = [e for e in events if e.cat in HOST_CATS and e.tid == self.host_tid
                            and inside(e) and e is not w]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self, substring: str = "") -> list[Event]:
        return [e for e in self.device_events if e.cat == "kernel" and substring in e.name]

    def busy(self, device: int) -> list[tuple[float, float]]:
        """Merged intervals in which an operation ran on `device`, in the window."""
        return _merge([(max(e.start, self.t0), min(e.end, self.t1))
                       for e in self.device_events if e.device == device])

    def busy_s(self) -> float:
        """Seconds in which the device ran an operation, averaged over the cards."""
        return sum(b - a for d in self.devices for a, b in self.busy(d)) / 1e6 / len(self.devices)

    def _host_labels(self, times: list[float]) -> list[str]:
        """What the driving thread was doing at each of `times` (sorted): its
        innermost host span there. One thread's spans nest, so a sweep with
        a stack of the open spans finds it."""
        spans = sorted(self.host_events, key=lambda e: (e.start, -e.end))
        stack: list[Event] = []
        labels, i = [], 0
        for t in times:
            while i < len(spans) and spans[i].start <= t:
                while stack and stack[-1].end <= spans[i].start:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1].end <= t:
                stack.pop()
            if not stack:
                labels.append("host: no operator (Python)")
            elif stack[-1].name == REQUEST:
                labels.append("host: Python inside the request")
            else:
                labels.append(f"host: {stack[-1].name}")
        return labels

    def breakdown(self) -> dict[str, list[list]]:
        """The device operations that took most time, and the idle time by
        what the host was doing, each in seconds averaged over the cards
        (at most 10 of each)."""
        ops: dict[str, float] = collections.defaultdict(float)
        for e in self.device_events:
            ops[short_name(e)] += (min(e.end, self.t1) - max(e.start, self.t0)) / 1e6
        gaps = []
        for d in self.devices:
            edges = [self.t0] + [x for ab in self.busy(d) for x in ab] + [self.t1]
            gaps += [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps.sort(key=lambda ab: ab[0] + ab[1])
        idle: dict[str, float] = collections.defaultdict(float)
        for (a, b), label in zip(gaps, self._host_labels([(a + b) / 2 for a, b in gaps])):
            idle[label] += (b - a) / 1e6
        n = max(len(self.devices), 1)

        def top(d):
            return [[k, v / n] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

        return {"device_ops": top(ops), "idle_gaps": top(idle)}
