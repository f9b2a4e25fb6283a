"""PyTorch port vs the JAX package: the timing and tracing utilities
(opticalflowclustering_tpu_torch.utils.profiling ↔
opticalflowclustering_tpu.utils.profiling), on the cases of
tests/test_utils_observability.py, with both packages' classes driven by the
same fake clock; plus the card-side timers the probe scripts use."""

import json
import os
import types

import pytest
import torch

import opticalflowclustering_tpu.utils.profiling as jprof
import opticalflowclustering_tpu_torch.utils.profiling as tprof

torch.set_num_threads(1)


def _stages(prof, names):
    t = prof.StageTimer()
    for name in names:
        with t.stage(name):
            pass
    return t


def test_stage_timer_accumulates_totals_and_counts(monkeypatch):
    # Both modules read the one `time` module: the JAX timer takes the first
    # six ticks, the port's the same six again.
    clock = iter([0.0, 1.0, 10.0, 12.5, 20.0, 20.25] * 2)
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    want = _stages(jprof, ["decode", "flow", "flow"])
    got = _stages(tprof, ["decode", "flow", "flow"])
    assert dict(got.counts) == dict(want.counts) == {"decode": 1, "flow": 2}
    assert dict(got.totals) == dict(want.totals)
    assert got.totals["flow"] == pytest.approx(2.75)


def test_stage_timer_report_order_matches_jax(monkeypatch):
    clock = iter([0.0, 0.5, 1.0, 4.0] * 2)
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: next(clock))
    want = _stages(jprof, ["small", "big"]).report()
    got = _stages(tprof, ["small", "big"]).report()
    assert got == want
    lines = got.splitlines()
    assert lines[0].startswith("big:") and lines[1].startswith("small:")
    assert "ms/call (1 calls)" in lines[0]


def test_stage_timer_syncs_a_cuda_tensor_only(monkeypatch):
    """A CUDA tensor synchronizes its device once, at the end of the stage;
    a CPU tensor and None wait for nothing."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    t = tprof.StageTimer()
    with t.stage("cpu", sync=torch.arange(8) * 2):
        pass
    with t.stage("none"):
        pass
    assert synced == []
    fake_cuda = types.SimpleNamespace(is_cuda=True, device=torch.device("cuda", 0))
    with t.stage("card", sync=fake_cuda):
        assert synced == []
    assert synced == [torch.device("cuda", 0)]
    assert t.counts == {"cpu": 1, "none": 1, "card": 1}


def test_throughput_meter_fps_matches_jax(monkeypatch):
    now = {"t": 100.0}
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: now["t"])
    meters = [mod.ThroughputMeter().start() for mod in (jprof, tprof)]
    for m in meters:
        m.update(30)
        m.update()
    now["t"] = 102.0
    want, got = meters
    assert got.elapsed() == want.elapsed() == pytest.approx(2.0)
    assert got.fps() == want.fps() == pytest.approx(31 / 2.0)


def test_zero_elapsed_is_not_a_division_error(monkeypatch):
    monkeypatch.setattr(tprof.time, "perf_counter", lambda: 5.0)
    m = tprof.ThroughputMeter().start()
    m.update(3)
    assert m.fps() == 0.0


def test_trace_to_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tprof.trace_to(str(logdir)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert any(e.key == "aten::matmul" for e in prof.key_averages())
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::matmul" for e in events)


def test_card_timers_refuse_the_cpu(monkeypatch):
    """event_ms, slope_ms and graph_ms time the card only: without CUDA they
    raise (graph_ms before it calls the function)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="times the card"):
        tprof.event_ms(lambda: None)
    with pytest.raises(RuntimeError, match="times the card"):
        tprof.slope_ms(lambda n: (lambda: None), 1, 2)
    calls = []
    with pytest.raises(RuntimeError, match="times the card"):
        tprof.graph_ms(lambda: calls.append(1))
    assert calls == []


def test_sm_clocks_read_nvidia_smi(monkeypatch):
    """sm_clocks_mhz asks nvidia-smi for card `index`'s clocks.sm and
    clocks.max.sm, without units, and returns them as floats."""
    seen = []

    def run(cmd, **kw):
        seen.append(cmd)
        return types.SimpleNamespace(stdout="1755, 1980\n")

    monkeypatch.setattr(tprof.subprocess, "run", run)
    assert tprof.sm_clocks_mhz(2) == (1755.0, 1980.0)
    assert seen == [["nvidia-smi", "--id=2", "--query-gpu=clocks.sm,clocks.max.sm",
                     "--format=csv,noheader,nounits"]]


def test_slope_ms_refuses_a_folded_loop(monkeypatch):
    """The slope is (t(hi) − t(lo)) / (hi − lo); a time that does not grow
    by half with the work (a hoisted or folded loop) raises."""
    times = {10: 1.0, 110: 6.0, 20: 1.0, 120: 1.2}
    monkeypatch.setattr(tprof, "event_ms", lambda fn, repeats=10: fn())
    assert tprof.slope_ms(lambda k: (lambda: times[k]), 10, 110) == pytest.approx(0.05)
    with pytest.raises(RuntimeError, match="does not grow"):
        tprof.slope_ms(lambda k: (lambda: times[k]), 20, 120)
