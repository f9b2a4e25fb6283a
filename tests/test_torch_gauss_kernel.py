"""The Gaussian-window solve kernel (`opticalflowclustering_tpu_torch.kernels.warp`
`gauss_solve`) and the flow's dispatch to it.

On the CPU: the plain version against `_update_flow(m, winsize, True)` and,
with the whole flow at OpenCV's accurate settings, against the JAX package
(imported inside those tests, so that the file runs where JAX is missing);
the gate, the span and the wrapper's refusals. Tests marked `cuda` hold
the kernel to the plain version bit for bit on the card and skip without
one; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gauss_kernel.py
"""

import importlib
import json

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch.flow import farneback as tfb
from opticalflowclustering_tpu_torch.kernels import warp as kw

torch.set_num_threads(1)

# cv2.calcOpticalFlowFarneback's accurate settings: OpenCV's
# FarnebackOpticalFlow defaults (5 levels, winsize 13, 10 iterations) with
# poly_n 7, poly_sigma 1.5 and OPTFLOW_FARNEBACK_GAUSSIAN.
ACCURATE = dict(pyr_scale=0.5, levels=5, winsize=13, iterations=10, poly_n=7, poly_sigma=1.5, gaussian_win=True)
ODD_WINSIZES = tuple(range(3, 18, 2))  # radius 1..8, one kernel instantiation each
# The 720p pyramid's levels at 5 levels (coarsest 45x80), odd widths (scalar
# stores), more than one tile, and frames narrower or lower than the window.
CARD_SHAPES = [(16, 720, 1280), (16, 360, 640), (16, 45, 80), (2, 37, 133), (3, 19, 130), (1, 33, 129),
               (1, 5, 7), (2, 3, 40)]


def _m(shape, seed: int, dev="cpu") -> torch.Tensor:
    """A random M [B, 5, H, W] with G11, G22 ≥ 0, as warp_m makes them."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn((shape[0], 5) + tuple(shape[1:]), generator=gen, device=dev) * 10
    m[:, 0] = m[:, 0].abs()
    m[:, 2] = m[:, 2].abs()
    return m.contiguous()


def _bits_off(got, want) -> int:
    return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum()) for g, w in zip(got, want))


@pytest.mark.parametrize("winsize", ODD_WINSIZES)
@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 5, 7), (1, 45, 80)])
def test_plain_version_is_update_flow_gaussian(shape, winsize):
    m = _m(shape, winsize)
    want = tfb._update_flow(m, winsize, True)
    for fn in (kw.gauss_solve_reference, kw.gauss_solve):
        got = fn(m, winsize)
        assert _bits_off(got, want) == 0
        assert got[0].shape == (shape[0],) + shape[1:]


@pytest.mark.parametrize("winsize", ODD_WINSIZES + (2, 12))
def test_taps_are_the_plain_versions_weights(winsize):
    r = winsize // 2
    kern = tfb.gauss_window(winsize)
    taps = kw.gauss_taps(winsize)
    assert taps.dtype == torch.float32 and taps.device.type == "cpu" and taps.shape == (r + 1,)
    assert kern.shape == (2 * r + 1,) and kern.sum() == pytest.approx(1.0)
    for d in range(r + 1):
        assert float(taps[d]) == float(np.float32(kern[r - d])) == float(np.float32(kern[r + d]))


def test_yardstick_counts():
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    assert kw.kernel_bytes("gauss_solve", 1, 1, 1) == 28
    assert kw.kernel_ops("gauss_solve", 1, 1, 1, 13) == 203
    assert kw.kernel_ops("gauss_solve", 2, 3, 4, 3) == 53 * 24
    ms, by = bound_ms(kw.kernel_bytes("gauss_solve", 16, 720, 1280), kw.kernel_ops("gauss_solve", 16, 720, 1280, 13))
    assert by == "bytes" and ms == pytest.approx(0.12325, abs=1e-5)


@pytest.mark.parametrize(
    "params,takes",
    [
        (dict(warp_mode="fast", gaussian_win=True, winsize=13), True),
        (dict(warp_mode="fast16", gaussian_win=True, winsize=13), True),
        (dict(warp_mode="fast", gaussian_win=True, winsize=17), True),
        (dict(warp_mode="fast", gaussian_win=True, winsize=2), True),
        (dict(warp_mode="fast", gaussian_win=True, winsize=19), False),
        (dict(warp_mode="fast", gaussian_win=True, winsize=1), False),
        (dict(warp_mode="exact", gaussian_win=True, winsize=13), False),
        (dict(warp_mode="select", gaussian_win=True, winsize=13), False),
        (dict(warp_mode="fast", gaussian_win=False, winsize=15), True),
        (dict(warp_mode="fast", gaussian_win=False, winsize=19), False),
    ],
)
def test_uses_kernels_admits_the_gaussian_window(params, takes):
    assert tfb.uses_kernels(tfb.FarnebackParams(**params)) is takes


def _pair(hw, seed):
    """Two uint8 [2, H, W] batches: a texture and the same texture moved
    by (1.5, -0.75) px, with independent noise."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(x, y):
        return 128 + 45 * np.sin(0.31 * x + 0.17 * y) + 30 * np.cos(0.13 * x - 0.27 * y)

    a = tex(x, y) + rng.normal(0, 2, (2, h, w))
    b = tex(x - 1.5, y + 0.75) + rng.normal(0, 2, (2, h, w))
    return np.clip(a, 0, 255).astype(np.uint8), np.clip(b, 0, 255).astype(np.uint8)


@pytest.fixture
def counted_solves(monkeypatch):
    """kw.box_solve and kw.gauss_solve counted, each still its plain version."""
    calls = {"box_solve": 0, "gauss_solve": 0}
    for name in calls:
        plain = getattr(kw, name)

        def counted(m, winsize, name=name, plain=plain):
            calls[name] += 1
            return plain(m, winsize)

        monkeypatch.setattr(kw, name, counted)
    return calls


@pytest.mark.parametrize("mode", ["fast", "fast16"])
def test_fused_loop_calls_gauss_solve_and_gives_the_plain_flow(counted_solves, monkeypatch, mode):
    """With the Gaussian window the fused loop calls the Gaussian wrapper at
    every level and iteration, and never box_solve; its flow is bitwise the
    unfused loop's (the same plain steps, gate closed)."""
    a, b = _pair((96, 160), 3)
    params = tfb.FarnebackParams(warp_mode=mode, **ACCURATE)
    levels = len(tfb.pyramid_plan(96, 160, params))
    got = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b), params)
    assert counted_solves == {"box_solve": 0, "gauss_solve": levels * params.iterations}
    monkeypatch.setattr(tfb, "uses_kernels", lambda p: False)
    want = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b), params)
    assert torch.equal(got, want)
    assert counted_solves["gauss_solve"] == levels * params.iterations


def test_box_window_still_calls_box_solve(counted_solves):
    a, b = _pair((64, 96), 4)
    params = tfb.FarnebackParams(warp_mode="fast")
    tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b), params)
    assert counted_solves == {"box_solve": len(tfb.pyramid_plan(64, 96, params)) * params.iterations,
                              "gauss_solve": 0}


def _flow_spans(params, tmp_path) -> list[dict]:
    from torch.profiler import ProfilerActivity, profile

    a, b = _pair((64, 96), 5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b), params)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and e["name"].startswith("ofc.flow.")]


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_each_gaussian_solve_opens_one_gauss_span_inside_a_solve_span(tmp_path, mode):
    params = tfb.FarnebackParams(warp_mode=mode, **{**ACCURATE, "iterations": 3})
    spans = _flow_spans(params, tmp_path)
    levels = len(tfb.pyramid_plan(64, 96, params))
    gauss = [e for e in spans if e["name"] == "ofc.flow.gauss"]
    solves = [e for e in spans if e["name"] == "ofc.flow.solve"]
    assert len(gauss) == levels * params.iterations and len(solves) == levels
    for g in gauss:
        assert any(s["ts"] <= g["ts"] and g["ts"] + g["dur"] <= s["ts"] + s["dur"] for s in solves)


def test_box_window_opens_no_gauss_span(tmp_path):
    spans = _flow_spans(tfb.FarnebackParams(warp_mode="fast"), tmp_path)
    assert spans and not any(e["name"] == "ofc.flow.gauss" for e in spans)


def test_kernel_entry_refuses_what_it_does_not_take():
    kw.reset_launches()
    m = _m((1, 16, 32), 0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.gauss_solve_cuda(m, 13)
    for winsize in (1, 19):
        with pytest.raises(ValueError, match="2 <= winsize <= 17"):
            kw.gauss_solve_cuda(m, winsize)
    with pytest.raises(ValueError, match=r"\[B, 5, H, W\]"):
        kw.gauss_solve_cuda(m[:, :4], 13)
    assert kw.LAUNCHES == {"warp_m": 0, "box_solve": 0, "gauss_solve": 0}


def test_plain_gaussian_solve_matches_jax_at_winsize_13():
    """jfb._update_flow(m, 13, True) ↔ the port's: rtol/atol 1e-4."""
    jfb = importlib.import_module("opticalflowclustering_tpu.flow.farneback")
    gather = importlib.import_module("opticalflowclustering_tpu.kernels.warp").update_matrices_gather
    rng = np.random.default_rng(13)
    r0, r1 = (rng.normal(0, 10, (90, 160, 5)).astype(np.float32) for _ in range(2))
    flow = rng.normal(0, 3.0, (90, 160, 2)).astype(np.float32)
    m = np.asarray(gather(r0, r1, flow))
    want = np.asarray(jfb._update_flow(m, 13, True))
    fx, fy = kw.gauss_solve(torch.from_numpy(np.ascontiguousarray(np.moveaxis(m, -1, 0)))[None], 13)
    got = np.stack([fx[0].numpy(), fy[0].numpy()], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_flow_at_the_accurate_settings_matches_jax(mode):
    """jfb.farneback_flow ↔ tfb.farneback_flow with the Gaussian window,
    poly_n 7, 10 iterations and 5 levels (clamped to 2 at 96×160 by the
    32-px stop), the JAX side eager: rtol/atol 1e-4."""
    jax = importlib.import_module("jax")
    jfb = importlib.import_module("opticalflowclustering_tpu.flow.farneback")
    a, b = _pair((96, 160), 6)
    with jax.disable_jit():
        want = np.asarray(jfb.farneback_flow(a, b, jfb.FarnebackParams(warp_mode=mode, **ACCURATE)))
    got = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b),
                             tfb.FarnebackParams(warp_mode=mode, **ACCURATE)).numpy()
    assert got.shape == want.shape == (2, 96, 160, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert abs(float(np.median(got[..., 0])) - 1.5) < 0.5  # real motion


def _rehearse_gauss_phase(monkeypatch, gauss):
    """chip_smoke.gauss_phase on the CPU: the kernel entries counted plain
    versions (the poly expansion's and the pyramid's taken on CPU tensors
    too, as on the card), with `gauss` for gauss_solve; the CUDA-event
    timer one host-clocked call."""
    import time

    import types

    import chip_smoke
    from opticalflowclustering_tpu_torch.kernels import poly as kp
    from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr

    for mod, name, plain in ((kw, "warp_m", kw.warp_m_reference), (kw, "gauss_solve", gauss),
                             (kp, "poly_expansion", kp.poly_expansion_reference),
                             (kpyr, "pyramid", kpyr.pyramid_reference)):
        def run(*args, mod=mod, name=name, plain=plain):
            mod.LAUNCHES[name] += 1
            return plain(*args)

        monkeypatch.setattr(mod, "pyramid_level" if mod is kpyr else name, run)
    monkeypatch.setattr(tfb, "poly_kernel_takes", lambda img, n: n <= tfb.MAX_KERNEL_POLY_N)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    takes = tfb.pyramid_kernel_takes
    monkeypatch.setattr(tfb, "pyramid_kernel_takes", lambda img, *args: takes(card, *args))

    def host_ms(fn, iters):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(chip_smoke, "loop_ms", host_ms)
    return chip_smoke


def test_chip_smoke_gauss_phase_rehearsal(monkeypatch, capsys):
    """Every level and every shape checked alone is checked at each winsize
    of GAUSS_WINSIZES; the levels are timed beside their bound, the finest
    in turns with the plain version; process_frames at the accurate
    settings launches what flow_runs designs."""
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke = _rehearse_gauss_phase(monkeypatch, kw.gauss_solve_reference)
    params = tfb.FarnebackParams(warp_mode="fast", **{**chip_smoke.ACCURATE, "iterations": 2})
    assert chip_smoke.ACCURATE == ACCURATE
    frames = synth_frames(5, 96, 160)
    got = chip_smoke.gauss_phase(torch.device("cpu"), "[cpu]", [(2, 40, 72), (2, 20, 36)], params, frames,
                                 [(1, 5, 7)])
    assert got["bound_by"] == "bytes" and got["max_abs_err"] == 0.0
    assert got["bound_ms"] == pytest.approx(2 * 40 * 72 * 28 / 3.35e12 * 1e3)
    levels = len(tfb.pyramid_plan(96, 160, params))
    assert got["launches"] == {"warp_m": 2 * levels, "box_solve": 0, "gauss_solve": 2 * levels,
                               "poly_expansion": 2 * levels, "pyramid": 2 * levels}
    out = capsys.readouterr().out
    for tag in ("check gauss_solve winsize 3..17 (odd) [2,5,40,72]: bitwise equal to the plain version",
                "check gauss_solve winsize 3..17 (odd) [1,5,5,7]: bitwise equal to the plain version",
                "time gauss_solve [2,5,40,72] winsize 13: kernel ", "(order plain, kernel, kernel, plain)",
                "time gauss_solve per 16-pair chunk (2 levels x 2 iterations = 4 launches): ",
                "slice accurate settings (5 levels, winsize 13, 2 iterations, poly_n 7, Gaussian window)"):
        assert tag in out, tag
    assert "time gauss_solve [1,5,5,7]" not in out


def test_chip_smoke_gauss_phase_fails_on_one_ulp(monkeypatch):
    """A kernel one unit in the last place off the plain version at one
    value fails the phase."""
    def one_ulp_off(m, winsize):
        fx, fy = kw.gauss_solve_reference(m, winsize)
        fy.view(torch.int32)[0, 4, 4] ^= 1
        return fx, fy

    chip_smoke = _rehearse_gauss_phase(monkeypatch, one_ulp_off)
    params = tfb.FarnebackParams(warp_mode="fast", **ACCURATE)
    with pytest.raises(AssertionError, match=r"gauss_solve winsize 3 \[1,5,9,9\]: 1 values differ in their bits"):
        chip_smoke.gauss_phase(torch.device("cpu"), "[cpu]", [(1, 9, 9)], params, None)


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file with -m cuda on one)")
    return torch.device("cuda")


CARD_CASES = [(shape, ws) for shape in CARD_SHAPES for ws in ODD_WINSIZES]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,winsize", CARD_CASES,
                         ids=["x".join(map(str, s)) + f"-ws{ws}" for s, ws in CARD_CASES])
def test_kernel_is_bitwise_the_plain_version(cuda, shape, winsize):
    m = _m(shape, 100 * winsize + sum(shape), cuda)
    m[..., ::7, ::5] = -0.0
    m[:, 3, 3::11, ::3] = 1e-40
    kw.reset_launches()
    got = kw.gauss_solve(m, winsize)
    assert kw.LAUNCHES == {"warp_m": 0, "box_solve": 0, "gauss_solve": 1}
    want = kw.gauss_solve_reference(m, winsize)
    torch.cuda.synchronize()
    off = _bits_off(got, want)
    assert off == 0, f"{off} of {2 * got[0].numel()} values differ in their bits"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 0, 8), (1, 8, 0), (65536, 1, 1)], ids=lambda s: "x".join(map(str, s)))
def test_launcher_refuses_what_it_does_not_take(cuda, shape):
    kw.reset_launches()
    with pytest.raises(RuntimeError, match="gauss_solve launch failed"):
        kw.gauss_solve(torch.zeros((shape[0], 5) + shape[1:], device=cuda), 13)
    assert kw.LAUNCHES["gauss_solve"] == 0


@pytest.mark.cuda
def test_flow_at_the_accurate_settings_on_the_card(cuda, monkeypatch):
    """`farneback_flow` on the card at the accurate settings: warp_m and
    gauss_solve at every level and iteration, no box_solve, and the flow
    within 1e-3 px (mean EPE) of the plain steps' on the card."""
    from opticalflowclustering_tpu_torch.kernels import poly as kp

    a, b = (torch.from_numpy(x).to(cuda) for x in _pair((180, 320), 7))
    params = tfb.FarnebackParams(warp_mode="fast", **ACCURATE)
    levels = len(tfb.pyramid_plan(180, 320, params))
    kw.reset_launches()
    kp.reset_launches()
    got = tfb.farneback_flow(a, b, params)
    runs = levels * params.iterations
    assert kw.LAUNCHES == {"warp_m": runs, "box_solve": 0, "gauss_solve": runs}
    assert kp.LAUNCHES == {"poly_expansion": 2 * levels}
    monkeypatch.setattr(tfb, "uses_kernels", lambda p: False)
    plain = tfb.farneback_flow(a, b, params)
    assert kw.LAUNCHES == {"warp_m": runs, "box_solve": 0, "gauss_solve": runs}
    assert bool(torch.isfinite(got).all())
    epe = float(torch.linalg.vector_norm(got - plain, dim=-1).mean())
    assert epe <= 1e-3, epe
