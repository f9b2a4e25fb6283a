"""The reduction of a traced window to the per-layer metrics and the
breakdown, on a Chrome trace made here by hand."""

from __future__ import annotations

import pytest

from ofc_bench import spec, trace, yardstick
from ofc_bench.tests.helpers import tiny

CONFIG = tiny("bounce720-fast.mem").config  # 96×128: levels 48×64 and 96×128


def _x(name, cat, ts, dur, **kw):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": kw.pop("pid", 1), "tid": kw.pop("tid", 7)}
    e["args"] = kw
    return e


def _trace():
    ev = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x(trace.REQUEST, "user_annotation", 1000.0, 1000.0),
        _x("aten::copy_", "cpu_op", 1100.0, 200.0),
        _x("cudaMemcpyAsync", "cuda_runtime", 1150.0, 100.0),
        _x("aten::add", "cpu_op", 1600.0, 50.0),
        _x("a kernel outside the window", "kernel", 0.0, 500.0, pid=0, device=0, grid=[1, 1, 1]),
        _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 1150.0, 150.0, pid=0, device=0),
        # warp_m at the coarse level (48×64, grid 2×6), then the fine one (96×128, grid 4×12), batch 4
        _x("warp_m_kernel(float const*, ...)", "kernel", 1400.0, 10.0, pid=0, device=0, grid=[2, 6, 4]),
        _x("warp_m_kernel(float const*, ...)", "kernel", 1410.0, 30.0, pid=0, device=0, grid=[4, 12, 4]),
        _x("void (anonymous namespace)::box_solve_kernel<7>(float const*, ...)", "kernel", 1440.0, 60.0, pid=0,
           device=0, grid=[1, 3, 4]),
        _x("void at::native::elementwise_kernel<128, 4, at::native::add>(int, float*)", "kernel", 1900.0, 200.0,
           pid=0, device=0, grid=[8, 1, 1]),
        _x("a host thread's op", "cpu_op", 1000.0, 1000.0, tid=99),
    ]
    return {"traceEvents": ev}


def _view(**kw):
    args = dict(pairs=8, config=CONFIG, devices=[0], peak_alloc_bytes=3 * 2**30)
    args.update(kw)
    return trace.TraceView(_trace(), **args)


def _read(name, view):
    return spec.metric_reader(name)(view)


def test_window_busy_and_idle():
    v = _view()
    assert v.window_s == pytest.approx(1e-3)
    # busy: [1150, 1300] + [1400, 1500] + [1900, 2000] (clipped to the window)
    assert v.busy_s() == pytest.approx(350e-6)
    assert _read("device_idle_pct", v) == pytest.approx(65.0)
    assert _read("peak_alloc_gib", v) == pytest.approx(3.0)
    assert _read("launches_per_pair", v) == pytest.approx(4 / 8)
    assert _read("h2d_ms_per_pair", v) == pytest.approx(0.150 / 8)


def test_idle_gaps_are_named_by_the_driving_threads_innermost_span():
    b = _view().breakdown()
    idle = dict(b["idle_gaps"])
    # [1000,1150] mid 1075: only the request span; [1300,1400] mid 1350 and
    # [1500,1900] mid 1700: the request span again ([1600,1650] is aten::add, not at mid)
    assert idle == pytest.approx({"host: Python inside the request": 650e-6})
    ops = dict(b["device_ops"])
    assert ops["at::native::elementwise_kernel<128, 4, at::native::add>"] == pytest.approx(100e-6)
    assert ops["warp_m_kernel"] == pytest.approx(40e-6)
    assert ops["box_solve_kernel<7>"] == pytest.approx(60e-6)
    assert ops["Memcpy HtoD (Pageable -> Device)"] == pytest.approx(150e-6)


def test_rooflines_from_the_frozen_counts():
    v = _view()
    fb = CONFIG["farneback"]

    def bound(k, h, w):
        return yardstick.bound_s(yardstick.kernel_bytes(k, 1, h, w), yardstick.kernel_ops(k, 1, h, w, fb["winsize"]))

    # 8 pairs, each through both levels `iterations` times, whatever the launches' grids
    for k, dur in (("warp_m", 40e-6), ("box_solve", 60e-6)):
        want = 8 * fb["iterations"] * (bound(k, 48, 64) + bound(k, 96, 128)) / dur * 100
        assert _read(f"{k}_roofline", v) == pytest.approx(want)


def test_rooflines_do_not_read_the_launch_grid():
    t = _trace()
    for e in t["traceEvents"]:
        if "warp_m_kernel" in e["name"]:
            e["args"]["grid"] = [4096, 1, 1]  # a flattened grid with the batch folded in
        if "box_solve_kernel" in e["name"]:
            del e["args"]["grid"]
    v = trace.TraceView(t, pairs=8, config=CONFIG, devices=[0], peak_alloc_bytes=None)
    for k in ("warp_m_roofline", "box_solve_roofline"):
        assert _read(k, v) == pytest.approx(_read(k, _view()))
    assert _read("warp_m_roofline", _view(pairs=0)) is None


def test_readers_find_nothing_without_device_events():
    t = _trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["cat"] not in trace.DEVICE_CATS]
    v = trace.TraceView(t, pairs=8, config=CONFIG, devices=[0], peak_alloc_bytes=None)
    for name in ("device_idle_pct", "peak_alloc_gib", "launches_per_pair", "h2d_ms_per_pair", "warp_m_roofline",
                 "box_solve_roofline"):
        assert _read(name, v) is None


def test_queue_clip_p90_reads_the_finished_clips_latencies():
    # 8 clips of one folder: the queue's two replicas finish them in pairs
    v = _view(clip_ms=[600.0, 610.0, 1200.0, 1190.0, 1800.0, 1810.0, 2400.0, 2420.0])
    assert _read("queue_clip_p90_ms", v) == pytest.approx(2400.0 + 0.3 * 20.0)  # sorted, at 0.9 × 7 = 6.3
    assert _read("queue_clip_p90_ms", _view()) is None
