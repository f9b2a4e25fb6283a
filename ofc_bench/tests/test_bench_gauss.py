"""The Gaussian-window configuration (`bounce720-gauss`) and the noise mix
on the CPU at tiny sizes: its reference against the port, planted faults
in the Gaussian solve, its cells found as files, and its two readers on a
Chrome trace made here by hand."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from ofc_bench import clips, limits, compare, run, spec, trace, yardstick, yardstick_gauss
from ofc_bench.reference import bounce_gauss
from ofc_bench.tests.helpers import tiny

GAUSS = "bounce720-gauss.mem"
NOISE = "bounce720-fast.noise"


def test_cells_load_as_files():
    cell = spec.load_cell(GAUSS)
    fb = cell.config["farneback"]
    assert fb == {"pyr_scale": 0.5, "levels": 5, "winsize": 13, "iterations": 10, "poly_n": 7, "poly_sigma": 1.5,
                  "gaussian_win": True, "warp_mode": "fast"}
    assert cell.config["reference"] == "bounce_gauss" and cell.chips == 1
    assert cell.config["limits"] == spec.load_cell("bounce720-fast.mem").config["limits"]
    assert [m["name"] for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["gauss_ms_per_pair", "gauss_solve_roofline"]
    noise = spec.load_cell(NOISE)
    mem = spec.load_cell("bounce720-fast.mem")
    assert noise.traffic == {**mem.traffic, "source": "noise", "why": noise.traffic["why"]}
    assert noise.config == mem.config and noise.chips == 1
    assert [m["name"] for m in noise.end_to_end] == ["pairs_per_s", "setup_s"]
    assert [m["name"] for m in noise.per_layer] == ["warp_m_roofline"]


def test_noise_clips_are_seeded_noise_of_the_cells_size():
    cell = tiny(NOISE)
    a = clips.make_clips(cell.config, cell.traffic, 2**33 + 1)
    b = clips.make_clips(cell.config, cell.traffic, 2**33 + 1)
    assert [x.shape for x in a] == [(11, 96, 128, 3)] * 8
    assert all((x == y).all() for x, y in zip(a, b))
    assert 100 < float(np.mean(a[0])) < 155 and len(np.unique(a[0])) == 256


def test_reference_equals_the_ports_tables_bitwise():
    from ofc_bench.entries import pipeline_config
    from opticalflowclustering_tpu_torch.pipeline.bounce import process_frames

    cell = tiny(GAUSS)
    frames = clips.make_clips(cell.config, cell.traffic, 2**31 + 21)[0]
    want = bounce_gauss.clip_tables(frames, cell.config, "cpu")
    got = process_frames(frames, pipeline_config(cell.config), "cpu")
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert np.array_equal(got[k].view(np.uint8), v.view(np.uint8)), k


def test_reference_refuses_the_box_window():
    cell = tiny("bounce720-fast.mem")
    with pytest.raises(ValueError, match="Gaussian window"):
        bounce_gauss.clip_tables(np.zeros((3, 96, 128, 3), np.uint8), cell.config, "cpu")


def test_reference_window_is_the_ports():
    from opticalflowclustering_tpu_torch.kernels import warp

    for winsize in range(2, 18):
        assert bounce_gauss.window_weights(winsize) == [float(t) for t in warp.gauss_taps(winsize)]


def _box_in_place_of_gauss(monkeypatch):
    from opticalflowclustering_tpu_torch.kernels import warp

    monkeypatch.setattr(warp, "gauss_solve", warp.box_solve_reference)


def _gauss_state_unchanged(monkeypatch):
    from opticalflowclustering_tpu_torch.kernels import warp

    def unchanged(m, winsize):
        z = torch.zeros_like(m[:, 0])
        return z, z.clone()

    monkeypatch.setattr(warp, "gauss_solve", unchanged)


# A weight one float32 ulp off (at distance 1, both sides) is not among
# them: it moves a tiny clip's mean |flow| by 3.7e-8 of its largest and no
# table entry, inside every limit; the kernel's weights are held bit for bit
# by its card tests and chip_smoke.py instead.
FAULTS = {"box_in_place_of_gauss": _box_in_place_of_gauss, "state_unchanged": _gauss_state_unchanged}


def test_the_cells_run_tiny_and_agree_with_their_references():
    for name in (GAUSS, NOISE):
        result = run.run_cell(tiny(name), 2**31 + 7, 0.5, False, device="cpu")
        assert result["correct"], (name, result["checks"])
        assert all(c["value"] == 0 for c in result["checks"].values())


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_gaussian_solve_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = run.run_cell(tiny(GAUSS), 2**31 + 3, 0.5, False, device="cpu")
    assert not result["correct"], result["checks"]


def test_the_bfloat16_control_fails_and_the_program_passes():
    cell = tiny(GAUSS)
    summary = limits.readings(cell, [4], 1, "cpu")
    assert compare.passed(compare.checks(summary["lower"], cell.config["limits"]))
    assert not compare.passed(compare.checks(summary["upper"], cell.config["limits"]))
    assert all(v == 0 for v in summary["lower"].values())


def test_frozen_counts_equal_the_ports():
    from opticalflowclustering_tpu_torch.kernels import warp

    for winsize in range(2, 18):
        for shape in ((16, 720, 1280), (16, 45, 80), (3, 29, 28)):
            assert yardstick_gauss.BYTES_PER_PIXEL * np.prod(shape) == warp.kernel_bytes("gauss_solve", *shape)
            assert (yardstick_gauss.ops_per_pixel(winsize) * np.prod(shape)
                    == warp.kernel_ops("gauss_solve", *shape, winsize))
    # level 0 at 720p, a 16-pair chunk: HBM-bound at 0.1232 ms, its operations 0.0894 ms
    assert yardstick.bound_s(28 * 16 * 921_600, 203 * 16 * 921_600) == pytest.approx(0.12325e-3, rel=1e-4)
    assert 203 * 16 * 921_600 / yardstick.F32_OPS_PER_S == pytest.approx(0.0894e-3, rel=1e-3)


CONFIG = tiny(GAUSS).config  # 96×128: levels 48×64 and 96×128


def _x(name, cat, ts, dur, tid=7, pid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}


def _trace():
    ev = [
        _x(trace.WINDOW, "user_annotation", 1000.0, 1000.0),
        _x(trace.REQUEST, "user_annotation", 1000.0, 1000.0),
        _x("ofc.flow.solve", "user_annotation", 1100.0, 500.0),
        _x("ofc.flow.gauss", "user_annotation", 1150.0, 100.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1160.0, 4.0, correlation=1),
        _x("ofc.flow.gauss", "user_annotation", 1300.0, 100.0),
        _x("cudaLaunchKernel", "cuda_runtime", 1310.0, 4.0, correlation=2),
        _x("cudaLaunchKernel", "cuda_runtime", 1450.0, 4.0, correlation=3),  # warp_m, outside the gauss spans
        _x("void (anonymous namespace)::gauss_solve_kernel<6>(float const*, ...)", "kernel", 1170.0, 20.0,
           tid=0, pid=0, device=0, correlation=1),
        _x("void (anonymous namespace)::gauss_solve_kernel<6>(float const*, ...)", "kernel", 1320.0, 60.0,
           tid=0, pid=0, device=0, correlation=2),
        _x("warp_m_kernel(float const*, ...)", "kernel", 1460.0, 90.0, tid=0, pid=0, device=0, correlation=3),
    ]
    return {"traceEvents": ev}


def _read(name, view):
    return spec.metric_reader(name)(view)


def test_readers_on_a_trace():
    v = trace.TraceView(_trace(), pairs=8, config=CONFIG, devices=[0], peak_alloc_bytes=None)
    assert _read("gauss_ms_per_pair", v) == pytest.approx(0.080 / 8)
    fb = CONFIG["farneback"]
    per_pair = sum(yardstick.bound_s(28 * h * w, 203 * h * w) for h, w in ((48, 64), (96, 128)))
    assert _read("gauss_solve_roofline", v) == pytest.approx(100 * 8 * fb["iterations"] * per_pair / 80e-6)


def test_readers_find_nothing_where_the_window_runs_plain():
    """The parent's trace: no `ofc.flow.gauss` span, no `gauss_solve_kernel`."""
    t = _trace()
    t["traceEvents"] = [e for e in t["traceEvents"] if e["name"] != "ofc.flow.gauss" and "gauss_solve" not in e["name"]]
    v = trace.TraceView(t, pairs=8, config=CONFIG, devices=[0], peak_alloc_bytes=None)
    assert _read("gauss_ms_per_pair", v) is None and _read("gauss_solve_roofline", v) is None
    v = trace.TraceView(_trace(), pairs=0, config=CONFIG, devices=[0], peak_alloc_bytes=None)
    assert _read("gauss_ms_per_pair", v) is None and _read("gauss_solve_roofline", v) is None


def test_traced_tiny_run_on_the_cpu():
    result = run.run_cell(tiny(GAUSS), 5, 0.5, True, device="cpu")
    assert result["correct"], result["checks"]
    # No device on the CPU: the readers find nothing to read.
    assert "gauss_solve_roofline" not in result["metrics"] and "gauss_ms_per_pair" not in result["metrics"]
