"""The readers of the port's own spans (`spans.py` and the metrics that use
it), on a Chrome trace made here by hand: two cards, kernels tied to their
launches by `correlation`, some launched inside an `ofc.flow.poly` span and
some outside, and host spans that cross the window's edges."""

from __future__ import annotations

import pytest

from ofc_bench import spec, trace
from ofc_bench.tests.helpers import tiny

CONFIG = tiny("bounce720-fast.mem").config
SPAN_METRICS = ("decode_wait_ms_per_pair", "stack_ms_per_pair", "readback_ms_per_pair", "pyramid_ms_per_pair",
                "poly_ms_per_pair", "pyramid_host_ms_per_pair", "poly_host_ms_per_pair")


def _x(name, cat, ts, dur, tid=7, pid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}


def _launch(ts, corr, op):
    """An operator at `ts` and the runtime call inside it that launches
    device operation `corr`."""
    return [_x(op, "cpu_op", ts, 8.0), _x("cudaLaunchKernel", "cuda_runtime", ts + 2.0, 4.0, correlation=corr)]


def _device(name, ts, dur, corr, device):
    return _x(name, "kernel", ts, dur, tid=device, pid=device, device=device, correlation=corr)


def _trace():
    ev = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x(trace.REQUEST, "user_annotation", 1000.0, 1000.0),
        # host spans: one crossing each edge of the window, one inside
        _x("ofc.stack", "user_annotation", 900.0, 150.0),  # 50 µs inside
        _x("ofc.decode.wait", "user_annotation", 1060.0, 40.0),
        _x("ofc.readback", "user_annotation", 1950.0, 100.0),  # 50 µs inside
        _x("ofc.stack", "user_annotation", 1500.0, 30.0),
        # two poly spans, each launching on its card; launches between them are outside
        _x("ofc.flow.poly", "user_annotation", 1100.0, 100.0),
        *_launch(1110.0, 1, "aten::mul"),  # card 0, inside
        *_launch(1150.0, 2, "aten::add"),  # card 1, inside
        *_launch(1210.0, 3, "aten::add"),  # card 0, outside
        _x("ofc.flow.poly", "user_annotation", 1300.0, 100.0),
        *_launch(1310.0, 4, "aten::to"),  # card 1, a copy, inside
        *_launch(1420.0, 5, "aten::add"),  # card 1, outside
        _x("ofc.flow.pyramid", "user_annotation", 1600.0, 50.0),
        _device("mul", 1120.0, 30.0, 1, 0),
        _device("add", 1160.0, 70.0, 2, 1),
        _device("add", 1220.0, 500.0, 3, 0),
        {**_device("Memcpy HtoD (Pageable -> Device)", 1330.0, 20.0, 4, 1), "cat": "gpu_memcpy"},
        _device("add", 1430.0, 200.0, 5, 1),
        # another thread's span of the same name is not the driving thread's
        _x("ofc.flow.poly", "user_annotation", 1000.0, 1000.0, tid=99),
    ]
    return {"traceEvents": ev}


def _view(t=None, pairs=10):
    return trace.TraceView(_trace() if t is None else t, pairs=pairs, config=CONFIG, devices=[0, 1],
                           peak_alloc_bytes=None)


def _read(name, view):
    return spec.metric_reader(name)(view)


def test_device_readers_count_what_was_launched_inside_their_span_on_every_card():
    v = _view()
    # mul (card 0) 30 + add (card 1) 70 + the copy (card 1) 20 µs, over 10 pairs
    assert _read("poly_ms_per_pair", v) == pytest.approx(0.120 / 10)
    # a pyramid span that launched nothing reads 0
    assert _read("pyramid_ms_per_pair", v) == 0.0


def test_device_readers_are_none_where_device_events_carry_no_correlation():
    t = _trace()
    for e in t["traceEvents"]:
        e["args"].pop("correlation", None)
    assert _read("poly_ms_per_pair", _view(t)) is None
    assert _read("pyramid_ms_per_pair", _view(t)) is None


def test_host_readers_clip_their_spans_to_the_window():
    v = _view()
    assert _read("stack_ms_per_pair", v) == pytest.approx((0.050 + 0.030) / 10)
    assert _read("readback_ms_per_pair", v) == pytest.approx(0.050 / 10)
    assert _read("decode_wait_ms_per_pair", v) == pytest.approx(0.040 / 10)
    # the driving thread's two poly spans (100 µs each) and one pyramid span (50 µs)
    assert _read("poly_host_ms_per_pair", v) == pytest.approx(0.200 / 10)
    assert _read("pyramid_host_ms_per_pair", v) == pytest.approx(0.050 / 10)


def test_every_reader_is_none_without_its_span_or_pairs():
    t = _trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if not e["name"].startswith("ofc.")]
    for name in SPAN_METRICS:
        assert _read(name, _view(t)) is None, name
        assert _read(name, _view(pairs=0)) is None, name


def test_device_readers_are_none_without_device_events():
    t = _trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["cat"] not in trace.DEVICE_CATS]
    assert _read("poly_ms_per_pair", _view(t)) is None
    assert _read("stack_ms_per_pair", _view(t)) == pytest.approx(0.008)
