"""The pyramid kernel (`opticalflowclustering_tpu_torch.kernels.pyramid`), its
entry, and `flow.farneback.farneback_flow`, which calls it.

On the CPU: the gate on every level of the benchmark's three
configurations and its refusals, the launcher's refusals, the kernel's
taps and yardstick, the flow's dispatch (the plain path for CPU tensors,
and on the card's path rehearsed on the CPU, the shapes the kernel is handed), the
plain version against the JAX package, and chip_smoke's pyramid phase
rehearsed. Tests marked `cuda` hold the kernel to the plain version bit
for bit on the card and skip without one; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pyramid_kernel.py
"""

import dataclasses
import importlib
import sys

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch import kernels
from opticalflowclustering_tpu_torch.flow import farneback as tfb
from opticalflowclustering_tpu_torch.kernels import build as kbuild
from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr
from opticalflowclustering_tpu_torch.ops.filters import gaussian_kernel
from torch_rehearsal import kernel_path_on_cpu, rehearse_phase  # noqa: F401

torch.set_num_threads(1)

FAST = tfb.FarnebackParams(warp_mode="fast")
# OpenCV's accurate settings (the benchmark's bounce720-gauss).
ACCURATE = tfb.FarnebackParams(pyr_scale=0.5, levels=5, winsize=13, iterations=10, poly_n=7, poly_sigma=1.5,
                               gaussian_win=True, warp_mode="fast")
# The benchmark's configurations: name → (H, W, params).
CONFIGS = {"bounce720-fast": (720, 1280, FAST), "bounce720-gauss": (720, 1280, ACCURATE),
           "cropflow-fast": (232, 220, FAST)}
# Every level a configuration builds: (ksize, sigma, (h_k, w_k)).
LEVELS = {name: [(tfb.pyramid_ksize(s), s, (h_k, w_k)) for _, h_k, w_k, s in tfb.pyramid_plan(h, w, p)]
          for name, (h, w, p) in CONFIGS.items()}


def _refuse_build(*args, **kwargs):
    raise AssertionError("the extension was built")


@pytest.fixture
def no_build(monkeypatch):
    """Make any build of the kernels' extension fail the test."""
    monkeypatch.setattr(kbuild, "build", _refuse_build)
    monkeypatch.setattr(kpyr, "build", _refuse_build)


def _frames(shape, seed: int) -> torch.Tensor:
    """Integer pixels laced with -0.0 and subnormals."""
    x = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32))
    x[..., ::7, ::5] = -0.0
    x[..., 3::11, ::3] = 1e-40
    return x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_the_kernel_takes_every_level_of_each_configuration(name):
    h, w, _ = CONFIGS[name]
    levels = LEVELS[name]
    assert [ks for ks, _, _ in levels] == {"bounce720-fast": [19, 9, 3, 3], "bounce720-gauss": [39, 19, 9, 3, 3],
                                           "cropflow-fast": [9, 3, 3]}[name]
    for ks, _, hw in levels:
        assert kpyr.pyramid_takes(ks, (h, w), hw)


@pytest.mark.parametrize(
    "ksize,hw,level_hw,takes",
    [
        (39, (1080, 1920), (68, 120), False),  # 1080p's fifth level: 1080 / 68 is no whole number
        (19, (1080, 1920), (135, 240), True),
        (3, (720, 1280), (720, 640), True),  # one axis at ratio 1
        (3, (720, 1280), (1440, 2560), False),  # an upsample
        (79, (720, 1280), (45, 80), True),  # the kernel's largest radius, 39
        (81, (720, 1280), (45, 80), False),  # radius 40
        (39, (20, 1280), (10, 80), True),  # a radius one below a side
        (41, (20, 1280), (10, 80), False),  # a radius as long as a side
        (3, (63, 75), (21, 15), True),  # odd factors
        (3, (62, 75), (21, 15), False),
    ],
)
def test_gate_refusals(ksize, hw, level_hw, takes):
    assert kpyr.MAX_KERNEL_PYRAMID_RADIUS == 39
    assert kpyr.pyramid_takes(ksize, hw, level_hw) is takes


@pytest.mark.parametrize(
    "make,args,match",
    [
        (lambda: torch.zeros(2, 8, 8), (3, 0.0, (4, 4)), "CUDA"),
        (lambda: torch.zeros(2, 8, 8, dtype=torch.float64), (3, 0.0, (4, 4)), "float32"),
        (lambda: torch.zeros(2, 8, 8, dtype=torch.uint8), (3, 0.0, (4, 4)), "float32"),
        (lambda: torch.zeros(2, 8, 16)[..., ::2], (3, 0.0, (4, 4)), "contiguous"),
        (lambda: torch.zeros(8, 8), (3, 0.0, (4, 4)), r"\[B, H, W\]"),
        (lambda: torch.zeros(1, 2, 8, 8), (3, 0.0, (4, 4)), r"\[B, H, W\]"),
    ],
)
def test_wrapper_refuses_what_the_kernel_does_not_take(no_build, make, args, match):
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kpyr.pyramid_cuda(make(), *args)
    assert kernels.LAUNCHES["pyramid"] == 0


@pytest.mark.parametrize(
    "ksize,level_hw,match",
    [(3, (3, 4), "divide"), (3, (16, 4), "divide"), (3, (0, 4), "divide"),
     (17, (4, 4), "radius"), (81, (4, 4), "radius"), (4, (4, 4), "odd ksize"), (15, (4, 4), "CUDA")],
)
def test_wrapper_refuses_levels_and_radii_it_does_not_take(no_build, ksize, level_hw, match):
    """The level's sides and the radius are checked before the device,
    and before any launch."""
    kernels.reset_launches()
    with pytest.raises(ValueError, match=match):
        kpyr.pyramid_cuda(torch.zeros(2, 8, 8), ksize, 1.0, level_hw)
    assert kernels.LAUNCHES["pyramid"] == 0


def test_kernel_bytes_and_ops_against_the_chunk_figures():
    """4 (H W + Ho Wo) bytes an image: per image of a 16-pair 720p chunk
    117,964,800 / 73,728,000 / 62,668,800 / 59,904,000 (/ 59,212,800) bytes
    at levels 0..3 (4), 628,531,200 a `fast` chunk (two images a level) and
    746,956,800 at the accurate settings."""
    per = [kpyr.kernel_bytes(16, 720, 1280, *hw) for _, _, hw in reversed(LEVELS["bounce720-gauss"])]
    assert per == [117_964_800, 73_728_000, 62_668_800, 59_904_000, 59_212_800]
    chunk = {name: 2 * sum(kpyr.kernel_bytes(16, h, w, *hw) for _, _, hw in LEVELS[name])
             for name, (h, w, _) in CONFIGS.items()}
    assert chunk["bounce720-fast"] == 628_531_200
    assert chunk["bounce720-gauss"] == 746_956_800
    assert chunk["cropflow-fast"] == 2 * 16 * 4 * (3 * 232 * 220 + 232 * 220 + 116 * 110 + 58 * 55)
    assert 628_531_200 / 3.35e12 * 1e3 == pytest.approx(0.1876, abs=5e-5)
    # Level 0: r = 1, one row and one column an output: 4 + 4 a pixel.
    assert kpyr.kernel_ops(3, 1, 720, 1280, 720, 1280) == 8 * 921_600
    # Level 3 (s = 8, r = 9): 2 rows of 1280 columns and 2 x 2 sums an output
    # at 28 each, then the rows' and the columns' averages.
    assert kpyr.kernel_ops(19, 1, 720, 1280, 90, 160) == 28 * (2 * 90 * 1280 + 4 * 90 * 160) + 3 * 3 * 90 * 160


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (3, 0.5), (9, 1.5), (19, 3.5), (39, 7.5), (79, 15.5)])
def test_kernel_taps_are_the_plain_versions_weights(ksize, sigma):
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    taps = kpyr._taps(ksize, sigma)
    assert taps.dtype == torch.float32 and taps.device.type == "cpu" and taps.shape == (r + 1,)
    want = np.float32([k[r - i] for i in range(r + 1)])
    assert np.array_equal(taps.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_cpu_flow_takes_the_plain_path(no_build, name):
    """On CPU tensors `farneback_flow` builds no extension and launches
    nothing: the plain blur and resize run, as before."""
    h, w, params = CONFIGS[name]
    scale = 8 if h > 300 else 2  # a smaller frame of the same plan's ratios
    a, b = (_frames((2, h // scale, w // scale), s) for s in (1, 2))
    kernels.reset_launches()
    got = tfb.farneback_flow(a, b, dataclasses.replace(params, iterations=1))
    assert kernels.LAUNCHES["pyramid"] == 0
    assert got.shape == (2, h // scale, w // scale, 2) and bool(torch.isfinite(got).all())
    assert "ofc_torch_kernels" not in sys.modules


@pytest.mark.parametrize("lead", [(), (2,)])
def test_dispatch_hands_the_kernel_contiguous_float32_frames(request, lead):
    """On the card's path with the launch replaced by the plain version, the
    flow hands the kernel each level's frames as contiguous float32
    [B, H, W] with the plan's sizes, and its flow keeps its bits."""
    calls = []

    def fake_launch(x, ksize, sigma, level_hw):
        calls.append((tuple(x.shape), x.dtype, x.is_contiguous(), ksize, level_hw))
        return kpyr.pyramid_reference(x, ksize, sigma, level_hw)

    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 256, lead + (96, 160)).astype(np.uint8))
    b = torch.from_numpy(rng.integers(0, 256, lead + (96, 160)).astype(np.uint8))
    params = tfb.FarnebackParams(warp_mode="fast", iterations=1)
    want = tfb.farneback_flow(a, b, params)
    request.getfixturevalue("kernel_path_on_cpu")("pyramid", fake_launch)
    got = tfb.farneback_flow(a, b, params)
    n = int(np.prod(lead)) if lead else 1
    plan = tfb.pyramid_plan(96, 160, params)
    assert calls == [((n, 96, 160), torch.float32, True, tfb.pyramid_ksize(s), (h_k, w_k))
                     for _, h_k, w_k, s in plan for _ in range(2)]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("ksize,sigma,hw,level_hw", [
    (9, 1.5, (232, 220), (58, 55)), (3, 0.5, (232, 220), (116, 110)), (3, 0.0, (232, 220), (232, 220)),
    (19, 3.5, (96, 160), (12, 20)), (5, 1.0, (63, 75), (21, 15)),
])
def test_plain_pyramid_matches_jax(ksize, sigma, hw, level_hw):
    """The plain version (the kernel's oracle) against the JAX package's
    blur and resize, eager, bit for bit, B = 2."""
    jax = importlib.import_module("jax")
    jfilters = importlib.import_module("opticalflowclustering_tpu.ops.filters")
    jresize = importlib.import_module("opticalflowclustering_tpu.ops.resize")
    x = _frames((2,) + hw, ksize).numpy()
    with jax.disable_jit():
        want = np.asarray(jresize.resize_linear(jfilters.gaussian_blur(x, ksize, sigma, border="reflect101"),
                                                level_hw))
    got = kpyr.pyramid_reference(torch.from_numpy(x), ksize, sigma, level_hw).numpy()
    assert got.shape == (2,) + level_hw
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_chip_smoke_pyramid_phase_rehearsal(monkeypatch, capsys, kernel_path_on_cpu):
    """Every level of each configuration is checked and timed beside its
    bound, and the chunk in turns with the plain stage; the launches are
    counted and the times, bounds and error measured returned."""
    chip_smoke = rehearse_phase(monkeypatch, kernel_path_on_cpu, "pyramid", kpyr.pyramid_reference)
    configs = [("small-fast", 2, 256, 320, FAST), ("small-gauss", 1, 512, 544, ACCURATE)]
    got = chip_smoke.pyramid_phase(torch.device("cpu"), "[cpu]", configs)
    assert set(got) == {"small-fast", "small-gauss"}
    for name, b, h, w, params in configs:
        plan = tfb.pyramid_plan(h, w, params)
        assert set(got[name]) == {"ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err"}
        assert got[name]["max_abs_err"] == 0.0 and got[name]["bound_by"] == "bytes"
        assert got[name]["bound_ms"] == pytest.approx(
            2 * sum(4 * b * (h * w + h_k * w_k) for _, h_k, w_k, _ in plan) / 3.35e12 * 1e3)
    n = [len(tfb.pyramid_plan(h, w, p)) for _, _, h, w, p in configs]
    assert n == [4, 5]
    assert kernels.LAUNCHES["pyramid"] == sum(6 * k for k in n)  # checked, timed alone, 2 chunks of 2 images
    out = capsys.readouterr().out
    for tag in ("check pyramid small-fast [2,256,320] to 32x40 (ksize 19), 64x80 (ksize 9), 128x160 (ksize 3), "
                "256x320 (ksize 3): bitwise equal to the plain version, max_abs_err 0.0",
                "time pyramid small-gauss [1,512,544] to 32x34 ksize 39: kernel ",
                "time pyramid small-fast per 16-pair chunk (4 levels x 2 images = 8 launches): kernel ",
                "(order plain, kernel, kernel, plain)"):
        assert tag in out, tag


def test_chip_smoke_pyramid_phase_fails_on_one_ulp(monkeypatch, kernel_path_on_cpu):
    """A kernel one unit in the last place off the plain version at one
    value fails the phase."""
    def one_ulp_off(x, ksize, sigma, level_hw):
        out = kpyr.pyramid_reference(x, ksize, sigma, level_hw)
        out.view(torch.int32)[0, 2, 3] ^= 1
        return out

    chip_smoke = rehearse_phase(monkeypatch, kernel_path_on_cpu, "pyramid", one_ulp_off)
    with pytest.raises(AssertionError, match=r"pyramid tiny \[1,64,64\] to 32x32 ksize 3: 1 values differ"):
        chip_smoke.pyramid_phase(torch.device("cpu"), "[cpu]", [("tiny", 1, 64, 64, FAST)])


def test_chip_smoke_counts_the_pyramid_among_the_flow_kernels():
    """Two launches a level and chunk where the kernel takes the level,
    none in the row-sharded flow."""
    import chip_smoke

    assert kernels.FLOW_KERNELS[-1] == "pyramid"
    assert chip_smoke.flow_runs(48, 16, 720, 1280, FAST)["pyramid"] == 24
    assert chip_smoke.flow_runs(48, 16, 720, 1280, ACCURATE)["pyramid"] == 30
    assert chip_smoke.flow_runs(74, 16, 232, 220, FAST)["pyramid"] == 30
    # 1080p at 5 levels: the two coarsest (68x120, 34x60) keep the plain path.
    assert chip_smoke.flow_runs(16, 16, 1080, 1920, ACCURATE)["pyramid"] == 8
    assert chip_smoke.spatial_runs(720, 96, 4, FAST)["pyramid"] == 0


# --- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file with -m cuda on one)")
    return torch.device("cuda")


# Every level of the three configurations at B = 16.
LEVEL_CASES = [(name, ks, s, hw) for name in CONFIGS for ks, s, hw in LEVELS[name]]
# Sides that are no multiple of the tile or of 4 (scalar loads), odd and
# mixed factors, the largest radius, a radius one below a side, a factor
# wider than a block's 128 columns.
ODD_CASES = [
    (2, 37, 133, 37, 133, 0.0), (3, 45, 130, 15, 26, 0.5), (1, 200, 300, 25, 50, 3.5),
    (1, 33, 129, 11, 43, 1.0), (2, 63, 75, 21, 15, 1.0), (2, 36, 133, 18, 19, 1.5),
    (1, 20, 1280, 10, 80, 7.5), (1, 720, 40, 45, 20, 15.5), (2, 1024, 1024, 32, 32, 15.5),
    (1, 64, 2048, 2, 16, 3.5), (1, 3, 5, 3, 5, 0.0), (4, 90, 160, 45, 80, 1.5),
]


def _card_frames(kind: str, shape, seed: int, dev) -> torch.Tensor:
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "uniform":
        return torch.rand(shape, generator=gen, device=dev) * 255
    x = torch.randint(0, 256, shape, generator=gen, device=dev).float()
    x[..., ::7, ::5] = -0.0
    x[..., 3::11, ::3] = 1e-40
    x[..., 5::13, 1::4] = -3e-39
    return x


def _assert_bitwise(got, want):
    torch.cuda.synchronize()
    assert got.shape == want.shape
    off = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    assert off == 0, f"{off} of {got.numel()} values differ in their bits, max |diff| {(got - want).abs().max()}"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["integer", "uniform"])
@pytest.mark.parametrize("name,ksize,sigma,level_hw", LEVEL_CASES,
                         ids=[f"{n}-{hw[0]}x{hw[1]}-k{ks}" for n, ks, _, hw in LEVEL_CASES])
def test_kernel_is_bitwise_the_plain_version_at_every_level(cuda, kind, name, ksize, sigma, level_hw):
    h, w, _ = CONFIGS[name]
    x = _card_frames(kind, (16, h, w), ksize + level_hw[0], cuda)
    kernels.reset_launches()
    got = kpyr.pyramid_cuda(x, ksize, sigma, level_hw)
    assert kernels.LAUNCHES["pyramid"] == 1
    _assert_bitwise(got, kpyr.pyramid_reference(x, ksize, sigma, level_hw))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,ho,wo,sigma", ODD_CASES, ids=lambda v: str(v))
def test_kernel_is_bitwise_the_plain_version_at_odd_shapes(cuda, b, h, w, ho, wo, sigma):
    ksize = tfb.pyramid_ksize(sigma)
    x = _card_frames("integer", (b, h, w), h + w, cuda)
    got = kpyr.pyramid_cuda(x, ksize, sigma, (ho, wo))
    _assert_bitwise(got, kpyr.pyramid_reference(x, ksize, sigma, (ho, wo)))


@pytest.mark.cuda
def test_kernel_reads_a_batch_view_at_an_unaligned_offset(cuda):
    """A contiguous view starting one float into its storage takes the
    scalar loads, with the same bits."""
    x = _card_frames("integer", (1, 2 * 90 + 1, 160), 9, cuda).view(-1)[1:1 + 2 * 90 * 160].view(2, 90, 160)
    got = kpyr.pyramid_cuda(x, 9, 1.5, (45, 40))
    _assert_bitwise(got, kpyr.pyramid_reference(x, 9, 1.5, (45, 40)))


@pytest.mark.cuda
def test_launcher_refuses_what_it_does_not_take(cuda):
    """The C launcher's own guard: more than 65535 images raise through the
    binding, and nothing is counted."""
    kernels.reset_launches()
    with pytest.raises(RuntimeError, match="pyramid_level launch failed"):
        kpyr.pyramid_cuda(torch.zeros((65536, 2, 2), device=cuda), 3, 0.0, (1, 1))
    assert kernels.LAUNCHES["pyramid"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_flow_is_bitwise_with_and_without_the_kernel(cuda, monkeypatch, name):
    """`farneback_flow` on the card at each configuration: the pyramid
    kernel two launches a level, and the flow bit for bit the flow whose
    pyramid runs the plain blur and resize."""
    h, w, params = CONFIGS[name]
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randint(0, 256, (4, h, w), generator=gen, device=cuda, dtype=torch.uint8)
    b = torch.roll(a, shifts=(2, 3), dims=(1, 2))
    kernels.reset_launches()
    got = tfb.farneback_flow(a, b, params)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pyramid"] == 2 * len(LEVELS[name])
    monkeypatch.setattr(kpyr, "pyramid_takes", lambda *args: False)
    want = tfb.farneback_flow(a, b, params)
    assert kernels.LAUNCHES["pyramid"] == 2 * len(LEVELS[name])
    _assert_bitwise(got, want)
