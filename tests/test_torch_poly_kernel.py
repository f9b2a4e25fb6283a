"""The polynomial-expansion kernel (`opticalflowclustering_tpu_torch.kernels.poly`)
and the dispatch in `flow.farneback.poly_expansion`.

On the CPU: the plain path for CPU tensors and for n above the kernel's
maximum, the wrapper's refusals, the dispatch's layouts, and the plain
version against the JAX package (imported inside that test, so that the
file runs where JAX is missing). Tests marked `cuda` hold the kernel to
the plain version bit for bit on the card and skip without one; run them
there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_poly_kernel.py
"""

import importlib
import sys
import time
import types

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch.flow import farneback as tfb
from opticalflowclustering_tpu_torch.kernels import build as kbuild
from opticalflowclustering_tpu_torch.kernels import poly as kp

torch.set_num_threads(1)

# Every pyramid level of the benchmark's two configurations (1280x720, 4
# levels; the 232x220 crop, 3 levels), chunk 16, and degenerate frames.
LEVEL_SHAPES = [
    (16, 720, 1280), (16, 360, 640), (16, 180, 320), (16, 90, 160),
    (16, 232, 220), (16, 116, 110), (16, 58, 55),
]
SMALL_SHAPES = [(1, 1, 1), (2, 3, 7), (1, 7, 3)]
# Widths that are no multiple of 4 (scalar stores) and more than one tile.
ODD_SHAPES = [(2, 37, 133), (3, 19, 130), (1, 33, 129)]
INPUTS = ("uniform", "constant", "integer", "zeros_subnormals")


def _sigma(n: int) -> float:
    """OpenCV's poly_sigma for poly_n = n: 0.9, 1.2, 1.5 at 3, 5, 7."""
    return round(0.15 * n + 0.45, 2)


# n 3, 5, 7 at every level shape and the degenerate frames; every n the
# kernel takes (1..8, one instantiation each) at the small and odd frames.
BITWISE_CASES = list(dict.fromkeys(
    [(shape, n) for shape in LEVEL_SHAPES + SMALL_SHAPES for n in (3, 5, 7)]
    + [(shape, n) for shape in SMALL_SHAPES + ODD_SHAPES for n in range(1, tfb.MAX_KERNEL_POLY_N + 1)]
))


def _refuse_build(*args, **kwargs):
    raise AssertionError("the extension was built")


@pytest.fixture
def no_build(monkeypatch):
    """Make any build of the kernels' extension fail the test."""
    monkeypatch.setattr(kbuild, "build", _refuse_build)
    monkeypatch.setattr(kp, "build", _refuse_build)


@pytest.mark.parametrize("channel_first", [False, True])
def test_cpu_tensor_takes_the_plain_path(no_build, channel_first):
    img = torch.from_numpy(np.random.default_rng(0).random((2, 3, 24, 40), dtype=np.float32))
    got = tfb.poly_expansion(img, 5, 1.2, channel_first=channel_first)
    want = tfb._poly_expansion_plain(img, 5, 1.2, channel_first=channel_first)
    assert torch.equal(got, want)
    assert got.shape == ((2, 3, 5, 24, 40) if channel_first else (2, 3, 24, 40, 5))
    assert "ofc_torch_kernels" not in sys.modules


@pytest.mark.parametrize("n,takes", [(1, True), (5, True), (7, True), (8, True), (9, False), (12, False)])
def test_n_above_the_kernels_maximum_takes_the_plain_path(no_build, n, takes):
    on_card = types.SimpleNamespace(device=torch.device("cuda", 0))
    assert tfb.poly_kernel_takes(on_card, n) is takes
    assert not tfb.poly_kernel_takes(torch.zeros(4, 4), n)
    assert tfb.MAX_KERNEL_POLY_N == 8
    if not takes:
        img = torch.from_numpy(np.random.default_rng(n).integers(0, 256, (1, 30, 34)).astype(np.float32))
        got = tfb.poly_expansion(img, n, 0.3 * n, channel_first=True)
        assert torch.equal(got, tfb._poly_expansion_plain(img, n, 0.3 * n, channel_first=True))


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: torch.zeros(2, 8, 8), "CUDA"),
        (lambda: torch.zeros(2, 8, 8, dtype=torch.float64), "float32"),
        (lambda: torch.zeros(2, 8, 8, dtype=torch.uint8), "float32"),
        (lambda: torch.zeros(2, 8, 16)[..., ::2], "contiguous"),
        (lambda: torch.zeros(8, 8), r"\[B, H, W\]"),
        (lambda: torch.zeros(1, 2, 8, 8), r"\[B, H, W\]"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(no_build, make, match):
    kp.reset_launches()
    with pytest.raises(ValueError, match=match):
        kp.poly_expansion(make(), 5, 1.2)
    assert kp.LAUNCHES == {"poly_expansion": 0}


def test_launch_counts_are_the_wrappers_own():
    from opticalflowclustering_tpu_torch.kernels import warp as kw

    kp.LAUNCHES["poly_expansion"] = 3
    kp.reset_launches()
    assert kp.LAUNCHES == {"poly_expansion": 0}
    assert set(kw.LAUNCHES) == {"warp_m", "box_solve", "gauss_solve"}


def test_kernel_taps_and_yardstick():
    g, xg, xxg, ig11, ig03, ig33, ig55 = tfb._poly_exp_consts(5, 1.2)
    taps = kp._taps(5, 1.2)
    assert taps.dtype == torch.float32 and taps.device.type == "cpu" and taps.shape == (22,)
    want = np.concatenate([g[5:], xg[5:], xxg[5:], np.float32([ig11, ig03, ig33, ig55])])
    assert np.array_equal(taps.numpy().view(np.int32), want.view(np.int32))
    assert kp.kernel_bytes(16, 720, 1280) == 16 * 921_600 * 24
    assert kp.kernel_ops(5, 1, 1, 1) == 136


@pytest.mark.parametrize("lead", [(), (2,), (2, 3)])
@pytest.mark.parametrize("channel_first", [False, True])
def test_dispatch_hands_the_kernel_contiguous_float32_images(monkeypatch, lead, channel_first):
    """With the gate open on the CPU and the launch replaced by the plain
    version, the dispatch's reshapes and layouts give the plain result."""
    calls = []

    def fake_launch(x, n, sigma):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous()))
        return kp.poly_expansion_reference(x, n, sigma)

    monkeypatch.setattr(tfb, "poly_kernel_takes", lambda img, n: True)
    monkeypatch.setattr(kp, "poly_expansion", fake_launch)
    rng = np.random.default_rng(1)
    img = torch.from_numpy(rng.integers(0, 256, lead + (20, 44)).astype(np.uint8))
    img = img.transpose(-1, -2).contiguous().transpose(-1, -2)  # not contiguous
    got = tfb.poly_expansion(img, 5, 1.2, channel_first=channel_first)
    want = tfb._poly_expansion_plain(img, 5, 1.2, channel_first=channel_first)
    b = int(np.prod(lead)) if lead else 1
    assert calls == [((b, 20, 44), torch.float32, True)]
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5)])
@pytest.mark.parametrize("hw", [(232, 220), (116, 110), (58, 55)])
def test_plain_poly_expansion_matches_jax_at_the_crops_levels(n, sigma, hw):
    """The plain version (the kernel's oracle) against the JAX package's
    `poly_expansion`, eager, bit for bit, at the crop's level shapes, B = 2."""
    jax = importlib.import_module("jax")
    jfb = importlib.import_module("opticalflowclustering_tpu.flow.farneback")
    rng = np.random.default_rng(hw[0] + n)
    img = rng.integers(0, 256, (2,) + hw).astype(np.float32)
    img[:, :3, :3] = rng.random((2, 3, 3), dtype=np.float32)
    with jax.disable_jit():
        want = np.asarray(jfb.poly_expansion(img, n, sigma, channel_first=True))
    got = tfb.poly_expansion(torch.from_numpy(img), n, sigma, channel_first=True).numpy()
    assert got.shape == (2, 5) + hw
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _rehearse_poly_phase(monkeypatch, launch):
    """chip_smoke.poly_phase on the CPU: the kernel entry `launch` counted,
    the CUDA-event timer one host-clocked call."""
    import chip_smoke

    def counted(x, n, sigma):
        kp.LAUNCHES["poly_expansion"] += 1
        return launch(x, n, sigma)

    def host_ms(fn, iters):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    monkeypatch.setattr(kp, "poly_expansion", counted)
    monkeypatch.setattr(chip_smoke, "loop_ms", host_ms)
    kp.reset_launches()
    return chip_smoke


def test_chip_smoke_poly_phase_rehearsal(monkeypatch, capsys):
    """Every level and every shape checked alone is checked at each n of
    POLY_CHECK; the levels are timed beside their bound, the finest in turns
    with the plain version; the launches are counted and the finest level's
    times and the error measured returned."""
    chip_smoke = _rehearse_poly_phase(monkeypatch, kp.poly_expansion_reference)
    levels = [(2, 40, 72), (2, 20, 36)]
    got = chip_smoke.poly_phase(torch.device("cpu"), "[cpu]", levels, tfb.FarnebackParams(), [(2, 9, 11)])
    assert set(got) == {"ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err"} and got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(2 * 40 * 72 * 24 / 3.35e12 * 1e3)
    assert got["max_abs_err"] == 0.0
    per_level = len(chip_smoke.POLY_CHECK)
    assert kp.LAUNCHES == {"poly_expansion": 3 * per_level + 2 + 1}
    out = capsys.readouterr().out
    for tag in ("check poly_expansion n=3, 5, 7 [2,40,72]: bitwise equal to the plain version",
                "check poly_expansion n=3, 5, 7 [2,9,11]: bitwise equal to the plain version",
                "time poly_expansion [2,40,72] n=5: kernel ", "(order plain, kernel, kernel, plain)",
                "time poly_expansion [2,20,36] n=5: kernel ",
                "time poly_expansion per 16-pair chunk (2 levels x 2 images = 4 launches): "):
        assert tag in out, tag
    assert "time poly_expansion [2,9,11]" not in out
    assert chip_smoke.poly_runs(48, 16, 720, 1280, tfb.FarnebackParams()) == 24
    assert chip_smoke.poly_runs(74, 16, 232, 220, tfb.FarnebackParams()) == 30


def test_chip_smoke_poly_phase_fails_on_one_ulp(monkeypatch):
    """A kernel one unit in the last place off the plain version at one
    value fails the phase."""
    def one_ulp_off(x, n, sigma):
        out = kp.poly_expansion_reference(x, n, sigma)
        out.view(torch.int32)[0, 2, 4, 4] ^= 1
        return out

    chip_smoke = _rehearse_poly_phase(monkeypatch, one_ulp_off)
    with pytest.raises(AssertionError, match=r"poly_expansion n=3 \[1,9,9\]: 1 values differ in their bits"):
        chip_smoke.poly_phase(torch.device("cpu"), "[cpu]", [(1, 9, 9)], tfb.FarnebackParams())


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file with -m cuda on one)")
    return torch.device("cuda")


def _image(kind: str, shape, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=dev)
    if kind == "constant":
        return torch.full(shape, 137.25, device=dev)
    if kind == "integer":
        return torch.randint(0, 256, shape, generator=gen, device=dev).float()
    # integer pixels laced with -0.0 and subnormals of both signs
    x = torch.randint(0, 256, shape, generator=gen, device=dev).float()
    u = torch.rand(shape, generator=gen, device=dev)
    x = torch.where(u < 0.25, torch.full_like(x, -0.0), x)
    x = torch.where((u >= 0.25) & (u < 0.35), torch.full_like(x, 1e-40), x)
    x = torch.where((u >= 0.35) & (u < 0.4), torch.full_like(x, -3e-39), x)
    return torch.where((u >= 0.4) & (u < 0.5), torch.zeros_like(x), x)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("shape,n", BITWISE_CASES, ids=["x".join(map(str, s)) + f"-n{n}" for s, n in BITWISE_CASES])
def test_kernel_is_bitwise_the_plain_version(cuda, kind, shape, n):
    sigma = _sigma(n)
    x = _image(kind, shape, 1000 * INPUTS.index(kind) + sum(shape) + n, cuda)
    kp.reset_launches()
    got = kp.poly_expansion(x, n, sigma)
    assert kp.LAUNCHES == {"poly_expansion": 1}
    want = kp.poly_expansion_reference(x, n, sigma)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (shape[0], 5) + shape[1:]
    off = (got.view(torch.int32) != want.view(torch.int32)).sum().item()
    assert off == 0, f"{off} of {got.numel()} values differ in their bits"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 0, 8), (1, 8, 0), (65536, 1, 1)], ids=lambda s: "x".join(map(str, s)))
def test_launcher_refuses_what_it_does_not_take(cuda, shape):
    """The C launcher's own guard: an empty frame or more than 65535 images
    raise through the binding, and nothing is counted."""
    kp.reset_launches()
    with pytest.raises(RuntimeError, match="poly_expansion launch failed"):
        kp.poly_expansion(torch.zeros(shape, device=cuda), 5, 1.2)
    assert kp.LAUNCHES == {"poly_expansion": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("channel_first", [False, True])
def test_dispatch_on_the_card(cuda, channel_first):
    """`flow.farneback.poly_expansion` on a CUDA uint8 [2, 3, H, W] batch:
    one launch, the plain version's bits in either layout."""
    img = torch.randint(0, 256, (2, 3, 90, 160), dtype=torch.uint8, device=cuda)
    kp.reset_launches()
    got = tfb.poly_expansion(img, 5, 1.2, channel_first=channel_first)
    assert kp.LAUNCHES == {"poly_expansion": 1}
    want = tfb._poly_expansion_plain(img, 5, 1.2, channel_first=channel_first)
    assert got.shape == want.shape
    assert torch.equal(got.contiguous().view(torch.int32), want.view(torch.int32))
    assert torch.equal(tfb.poly_expansion(img, 9, 2.0), tfb._poly_expansion_plain(img, 9, 2.0))
    assert kp.LAUNCHES == {"poly_expansion": 1}
