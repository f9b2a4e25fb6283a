"""The port's own spans in a traced window.

The port opens a `record_function` span at each stage of its pipeline
(`ofc.<stage>`, `opticalflowclustering_tpu_torch/utils/profiling.span`) on
the thread that drives the requests. A per-layer metric of a stage reads
either the host time inside its span (`host_ms_per_pair`) or the device time
of the kernels, copies and fills launched inside it (`device_ms_per_pair`).
Both return None where the trace holds no such span, as for a program that
opens none.
"""

from __future__ import annotations

import bisect

from ofc_bench.trace import _merge


def _intervals(view, name: str) -> list[tuple[float, float]]:
    """The driving thread's `name` spans in the window, clipped to it and
    merged (µs on the host's clock)."""
    return _merge([(max(e.start, view.t0), min(e.end, view.t1)) for e in view.host_events if e.name == name])


def host_ms_per_pair(view, name: str) -> float | None:
    """ms a flow pair that the driving thread spent inside `name` spans."""
    spans = _intervals(view, name)
    if not spans or not view.pairs:
        return None
    return sum(b - a for a, b in spans) / 1e3 / view.pairs


def device_ms_per_pair(view, name: str) -> float | None:
    """ms a flow pair of device time, summed over the cards, of every kernel,
    copy and fill whose launch started inside a `name` span of the driving
    thread. A device operation is tied to the CUDA API call that launched it
    by their shared `correlation`; None where the device events carry none."""
    spans = _intervals(view, name)
    if not spans or not view.pairs or not any("correlation" in e.args for e in view.device_events):
        return None
    launched = {e.args["correlation"]: e.start for e in view.host_events
                if e.cat in ("cuda_runtime", "cuda_driver") and "correlation" in e.args}
    starts = [a for a, _ in spans]

    def inside(t: float | None) -> bool:
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        return i >= 0 and t < spans[i][1]

    total = sum(min(e.end, view.t1) - max(e.start, view.t0) for e in view.device_events
                if inside(launched.get(e.args.get("correlation"))))
    return total / 1e3 / view.pairs
