"""PyTorch port vs the JAX package: Farneback flow and the plain versions of
the two CUDA kernels (opticalflowclustering_tpu_torch.flow.farneback and
.kernels.warp ↔ opticalflowclustering_tpu.flow.farneback and .kernels.warp).

On the CPU the JAX 'fast'/'fast16' flow runs `update_matrices_gather`, the
oracle the Pallas kernels are held to; the port's `warp_m_reference` and
`box_solve_reference` are held to it here, and the CUDA kernels are held to
those on the card by chip_smoke.py. JAX runs un-jitted for every bitwise
check."""

import jax
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.flow import farneback as jfb
from opticalflowclustering_tpu.kernels.warp import (
    quantize_r1_fast16 as j_quantize_r1_fast16,
)
from opticalflowclustering_tpu.kernels.warp import update_matrices_gather
from opticalflowclustering_tpu_torch import kernels, runtime
from opticalflowclustering_tpu_torch.flow import farneback as tfb
from opticalflowclustering_tpu_torch.kernels import poly as kp
from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr
from opticalflowclustering_tpu_torch.kernels import warp as kw
from torch_rehearsal import kernel_path_on_cpu  # noqa: F401

torch.set_num_threads(1)


def _cf(a):
    """[..., H, W, 5] numpy → channel-first [B, 5, H, W] tensor."""
    h, w = a.shape[-3:-1]
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3))).reshape(
        -1, 5, h, w
    )


def _planes(flow):
    h, w = flow.shape[-3:-1]
    return (
        torch.from_numpy(np.ascontiguousarray(flow[..., 0])).reshape(-1, h, w),
        torch.from_numpy(np.ascontiguousarray(flow[..., 1])).reshape(-1, h, w),
    )


def _cl(m, lead):
    """Channel-first [B, 5, H, W] tensor → [*lead, H, W, 5] numpy."""
    h, w = m.shape[-2:]
    return np.moveaxis(m.numpy(), 1, -1).reshape(tuple(lead) + (h, w, 5))


def _rand_case(rng, hw, sigma, lead=()):
    h, w = hw
    r0 = rng.normal(0, 10, lead + (h, w, 5)).astype(np.float32)
    r1 = rng.normal(0, 10, lead + (h, w, 5)).astype(np.float32)
    flow = rng.normal(0, sigma, lead + (h, w, 2)).astype(np.float32)
    return r0, r1, flow


@pytest.mark.parametrize("channel_first", [False, True])
@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5)])
def test_poly_expansion(n, sigma, channel_first):
    """jfb.poly_expansion ↔ tfb.poly_expansion: rtol 1e-5, atol 1e-5."""
    rng = np.random.default_rng(10)
    img = rng.integers(0, 256, (2, 72, 136)).astype(np.float32)
    want = np.asarray(jfb.poly_expansion(img, n, sigma, channel_first=channel_first))
    got = tfb.poly_expansion(
        torch.from_numpy(img), n, sigma, channel_first=channel_first
    ).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "hw,sigma,lead",
    [
        ((64, 128), 3.0, ()),
        ((40, 100), 2.0, ()),
        ((72, 300), 60.0, ()),  # large displacements reach the masks
        ((200, 136), 8.0, ()),
        ((48, 160), 4.0, (2, 3)),  # batched
    ],
)
def test_warp_m_reference_matches_update_matrices_gather(hw, sigma, lead):
    """jax kernels.warp.update_matrices_gather ↔ kw.warp_m_reference (and
    the kw.warp_m wrapper on CPU tensors): rtol 1e-4, atol 1e-3, the
    reference's kernel-vs-oracle tolerance (tests/test_pallas_warp.py:62)."""
    rng = np.random.default_rng(11)
    r0, r1, flow = _rand_case(rng, hw, sigma, lead)
    want = np.asarray(update_matrices_gather(r0, r1, flow))
    fx, fy = _planes(flow)
    got = _cl(kw.warp_m_reference(_cf(r0), _cf(r1), fx, fy), lead)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    before = dict(kernels.LAUNCHES)
    np.testing.assert_array_equal(
        _cl(kw.warp_m(_cf(r0), _cf(r1), fx, fy), lead), got
    )
    assert kernels.LAUNCHES == before  # the CPU path launches no kernel


def test_warp_m_reference_bitwise_on_integer_exact_case():
    """Integer coefficients and integer flow make every operation exact in
    float32: interior bitwise equal (test_pallas_warp.py:65-79)."""
    rng = np.random.default_rng(12)
    h, w = 72, 300
    r0 = rng.integers(-8, 8, (h, w, 5)).astype(np.float32)
    r1 = rng.integers(-8, 8, (h, w, 5)).astype(np.float32)
    flow = rng.integers(-150, 150, (h, w, 2)).astype(np.float32)
    want = np.asarray(update_matrices_gather(r0, r1, flow))
    got = _cl(kw.warp_m_reference(_cf(r0), _cf(r1), *_planes(flow)), ())
    np.testing.assert_array_equal(got[5:-5, 5:-5], want[5:-5, 5:-5])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("mode", ["exact", "fast", "fast16"])
def test_update_matrices_modes(mode):
    """jfb.update_matrices ↔ tfb.update_matrices per warp mode, with
    displacements large enough that 'exact' and 'fast' differ."""
    rng = np.random.default_rng(13)
    r0, r1, flow = _rand_case(rng, (72, 300), 80.0)
    want = np.asarray(jfb.update_matrices(r0, r1, flow, warp_mode=mode))
    got = _cl(tfb.update_matrices(_cf(r0), _cf(r1), *_planes(flow), mode), ())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_quantize_r1_fast16_bitwise():
    """jax quantize_r1_fast16 (channel-last) ↔ kw.quantize_r1_fast16
    (channel-first): the same bf16 rounding of channels 0–3."""
    rng = np.random.default_rng(14)
    r1 = rng.normal(0, 100, (2, 16, 40, 5)).astype(np.float32)
    want = np.asarray(j_quantize_r1_fast16(r1))
    got = _cl(kw.quantize_r1_fast16(_cf(r1)), (2,))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize(
    "hw,winsize",
    [((64, 128), 15), ((72, 300), 17), ((200, 136), 15), ((64, 128), 5)]
    # Every winsize the box_solve kernel takes, on frames narrower or lower
    # than the window, and on the 720p pyramid's coarsest level.
    + [(hw, ws) for hw in [(5, 7), (3, 40), (90, 160)] for ws in range(1, 18, 2)],
)
def test_box_solve_reference_matches_update_flow(hw, winsize):
    """jfb._update_flow(m, winsize, False), un-jitted ↔ kw.box_solve_reference
    and the kw.box_solve wrapper on a CPU tensor: bitwise. Both run the
    symmetric-pair box sum, the scaling and the solve in the same float32
    order, which is what the CUDA kernel is held to on the card."""
    rng = np.random.default_rng(15)
    r0, r1, flow = _rand_case(rng, hw, 3.0, (2,))
    m = np.asarray(update_matrices_gather(r0, r1, flow))
    want = np.asarray(jfb._update_flow(m, winsize, False))
    for fn in (kw.box_solve_reference, kw.box_solve):
        fx, fy = fn(_cf(m), winsize)
        got = np.stack([fx.numpy(), fy.numpy()], axis=-1)
        np.testing.assert_array_equal(got, want)


def test_kernel_bytes_and_bounds():
    """The bytes each pipeline kernel must move (68 per pixel for warp_m: R0,
    R1, the flow and M; 28 for box_solve: M and the flow) and the bounds
    chip_smoke.py prints beside their times at [16,5,720,1280]."""
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    assert kw.kernel_bytes("warp_m", 1, 1, 1) == 68
    assert kw.kernel_bytes("box_solve", 1, 1, 1) == 28
    assert kw.kernel_bytes("warp_m", 16, 720, 1280) == 68 * 14_745_600
    assert kw.kernel_ops("box_solve", 1, 1, 1, 15) == 158
    assert kw.kernel_ops("box_solve", 2, 3, 4, 1) == 18 * 24
    assert kw.kernel_ops("warp_m", 1, 2, 2) == 404
    ms, by = bound_ms(kw.kernel_bytes("box_solve", 16, 720, 1280),
                      kw.kernel_ops("box_solve", 16, 720, 1280, 15))
    assert by == "bytes" and ms == pytest.approx(0.12325, abs=1e-5)
    ms, by = bound_ms(kw.kernel_bytes("warp_m", 16, 720, 1280),
                      kw.kernel_ops("warp_m", 16, 720, 1280))
    assert by == "bytes" and ms == pytest.approx(0.29931, abs=1e-5)
    assert bound_ms(0, 33.5e9) == (pytest.approx(1.0), "operations")


def test_update_flow_gaussian_window():
    """jfb._update_flow(m, 15, True) ↔ tfb._update_flow: rtol/atol 1e-4."""
    rng = np.random.default_rng(16)
    r0, r1, flow = _rand_case(rng, (64, 128), 3.0)
    m = np.asarray(update_matrices_gather(r0, r1, flow))
    want = np.asarray(jfb._update_flow(m, 15, True))
    fx, fy = tfb._update_flow(_cf(m), 15, True)
    got = np.stack([fx[0].numpy(), fy[0].numpy()], axis=-1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _pair(hw, seed):
    """A textured frame and the same texture moved by (1.5, -0.75) px, with
    independent noise: uint8 [2, H, W] each (a batch of two pairs)."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)

    def tex(x, y):
        return (
            128
            + 45 * np.sin(0.31 * x + 0.17 * y)
            + 30 * np.cos(0.13 * x - 0.27 * y)
            + 20 * np.sin(0.05 * x * 0.7 + 0.09 * y)
        )

    a = tex(x, y) + rng.normal(0, 2, (2, h, w))
    b = tex(x - 1.5, y + 0.75) + rng.normal(0, 2, (2, h, w))
    return (np.clip(a, 0, 255).astype(np.uint8), np.clip(b, 0, 255).astype(np.uint8))


@pytest.mark.parametrize("mode", ["exact", "fast", "fast16", "select"])
@pytest.mark.parametrize("hw", [(64, 128), (75, 131)])
def test_farneback_flow_epe_vs_jax(hw, mode):
    """jfb.farneback_flow ↔ tfb.farneback_flow in the same warp mode, at
    warp_radius 8 (read by 'select' only): mean endpoint error ≤ 1e-4 px.
    (75, 131) takes the banded-matmul resize. A tolerance check, so the JAX
    side runs jitted (measured mean EPE ≤ 3.5e-7 px for exact/fast and
    ≤ 2e-6 px for fast16, where a jitted multiply-add can flip a bf16
    rounding)."""
    a, b = _pair(hw, 17)
    params = jfb.FarnebackParams(warp_mode=mode, warp_radius=8)
    want = np.asarray(jax.jit(lambda p, q: jfb.farneback_flow(p, q, params))(a, b))
    got = tfb.farneback_flow(
        torch.from_numpy(a), torch.from_numpy(b), tfb.FarnebackParams(warp_mode=mode, warp_radius=8)
    ).numpy()
    assert got.shape == want.shape == (2,) + hw + (2,)
    assert np.isfinite(got).all()
    epe = np.sqrt(((got - want) ** 2).sum(-1)).mean()
    assert epe <= 1e-4, epe
    # The flow is real motion, not zero: the pair moves by about (1.5, -0.75).
    assert abs(float(np.median(got[..., 0])) - 1.5) < 0.5


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_farneback_flow_epe_vs_cv2_on_the_demo_clip(mode):
    """cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15, 3, 5, 1.2,
    0), the reference's call, ↔ tfb.farneback_flow (the plain versions on the
    CPU) on 4 pairs of real footage (demo_out/601_3.avi frames 30–34, up to
    ~33 px of motion): mean EPE < 1e-3 px on every pair, the gate of the
    JAX package's tests/test_pallas_warp.py (measured ≤ 6.6e-7 px)."""
    import os

    import cv2

    from opticalflowclustering_tpu_torch.io.video import read_video_bgr
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray

    demo = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo_out", "601_3.avi")
    gray = bgr2gray(torch.from_numpy(read_video_bgr(demo, 35)[30:]))
    got = tfb.farneback_flow(gray[:-1], gray[1:], tfb.FarnebackParams(warp_mode=mode)).numpy()
    for i in range(4):
        want = cv2.calcOpticalFlowFarneback(gray[i].numpy(), gray[i + 1].numpy(), None, 0.5, 3, 15, 3, 5, 1.2, 0)
        epe = float(np.sqrt(((got[i] - want) ** 2).sum(-1)).mean())
        assert epe < 1e-3, (i, epe)
    assert np.abs(got).max() > 10  # real motion


def test_farneback_helpers_are_copies():
    """pyramid_plan, _poly_exp_consts and _border_taper are numpy copies of
    the JAX package's; each result is equal."""
    for hw in [(720, 1280), (75, 131), (40, 33), (232, 220)]:
        for p in [(0.5, 3), (0.6, 5)]:
            jp = jfb.FarnebackParams(pyr_scale=p[0], levels=p[1])
            tp = tfb.FarnebackParams(pyr_scale=p[0], levels=p[1])
            assert tfb.pyramid_plan(*hw, tp) == jfb.pyramid_plan(*hw, jp)
        np.testing.assert_array_equal(tfb._border_taper(*hw), jfb._border_taper(*hw))
    for n, sigma in [(5, 1.2), (7, 1.5), (5, 0.0)]:
        for got, want in zip(tfb._poly_exp_consts(n, sigma), jfb._poly_exp_consts(n, sigma)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tfb._BORDER_SCALE, jfb._BORDER_SCALE)


def test_kernel_entries_raise_on_cpu_tensors():
    """The CUDA kernel entries take CUDA tensors only: CPU tensors raise
    before any build, and no launch is counted."""
    rng = np.random.default_rng(18)
    r0, r1, flow = _rand_case(rng, (16, 32), 1.0)
    before = dict(kernels.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.warp_m_cuda(_cf(r0), _cf(r1), *_planes(flow))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kw.box_solve_cuda(_cf(r0), 15)
    with pytest.raises(ValueError, match="odd winsize"):
        kw.box_solve_cuda(_cf(r0), 19)
    assert kernels.LAUNCHES == before


def _kernel_case(name: str):
    """(entry's module, arguments) of a small input each flow kernel takes."""
    gen = torch.Generator().manual_seed(19)
    m = torch.randn((2, 5, 12, 20), generator=gen) * 10
    img = torch.randint(0, 256, (2, 16, 24), generator=gen).float()
    return {
        "warp_m": (kw, (m, torch.randn((2, 5, 12, 20), generator=gen) * 10,
                        torch.randn((2, 12, 20), generator=gen), torch.randn((2, 12, 20), generator=gen))),
        "box_solve": (kw, (m, 5)),
        "gauss_solve": (kw, (m, 5)),
        "poly_expansion": (kp, (img, 5, 1.2)),
        "pyramid": (kpyr, (img, 3, 0.5, (8, 12))),
    }[name]


def _same_bits(got, want) -> bool:
    got, want = ((t,) if isinstance(t, torch.Tensor) else t for t in (got, want))
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32)) for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("name", kernels.FLOW_KERNELS)
def test_each_flow_kernel_has_one_entry_and_one_count(name, request):
    """Each flow kernel's entry (named after its launch key) runs its plain
    version bit for bit on a CPU tensor, with no launch counted; with the
    rehearsal's patch it calls its counted launcher once; and a reset of the
    registry zeroes every kernel's count."""
    mod, args = _kernel_case(name)
    entry, plain = getattr(mod, name), getattr(mod, f"{name}_reference")
    want = plain(*args)
    kernels.reset_launches()
    assert _same_bits(entry(*args), want)
    assert not any(kernels.LAUNCHES.values())
    request.getfixturevalue("kernel_path_on_cpu")
    assert _same_bits(entry(*args), want)
    assert kernels.LAUNCHES == {k: int(k == name) for k in kernels.LAUNCHES}
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 3))
    kernels.reset_launches()
    assert kernels.LAUNCHES == dict.fromkeys(kernels.FLOW_KERNELS + ("loop_probe", "dynslice"), 0)


def test_unsupported_modes_and_devices_raise(monkeypatch):
    """'select' is a mode of the port, with its radius kept; an unknown mode
    and a device that is not there raise."""
    assert tfb.FarnebackParams(warp_mode="select", warp_radius=8).warp_radius == 8
    with pytest.raises(ValueError, match="bogus"):
        tfb.FarnebackParams(warp_mode="bogus")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.resolve_device("cuda")
    assert runtime.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        runtime.resolve_device("meta")
