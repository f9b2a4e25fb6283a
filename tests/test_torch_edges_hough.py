"""PyTorch port vs the JAX package: threshold, edges (Sobel, Laplacian,
Canny, bilateral), Hough circles in both modes, and the detectcircles CLI
(opticalflowclustering_tpu_torch.ops.threshold / .edges / .hough /
.cli.detectcircles ↔ the JAX modules of the same names).

Inputs are made with numpy from a seed, are frames of demo_out/601_3.avi,
or are images with circles drawn by cv2.circle. The JAX ops run un-jitted
(op by op) except `hough_circles`, which is one jitted program: the
integer and uint8 paths and the float paths in one fixed operation order
are held bitwise; bilateral (float exp) within 1 code; Hough to the same
circles, equal in count, x, y and r within 1e-3 px."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.io.video import read_video_bgr
from opticalflowclustering_tpu.ops import edges as jed
from opticalflowclustering_tpu.ops import hough as jho
from opticalflowclustering_tpu.ops import threshold as jth
from opticalflowclustering_tpu_torch.ops import edges as ted
from opticalflowclustering_tpu_torch.ops import hough as tho
from opticalflowclustering_tpu_torch.ops import threshold as tth

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
RNG = np.random.default_rng(9)
IMG = RNG.integers(0, 256, size=(72, 96, 3), dtype=np.uint8)
GRAY = cv2.cvtColor(IMG, cv2.COLOR_BGR2GRAY)
FRAME = cv2.cvtColor(read_video_bgr(DEMO, 31)[30], cv2.COLOR_BGR2GRAY)


def _t(a):
    return torch.from_numpy(np.array(a))


def _circles(h, w, n, seed, fill=False):
    """n circles of random centre, radius and grey level on a flat ground."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 30, np.uint8)
    for _ in range(n):
        r = int(rng.integers(min(h, w) // 12, min(h, w) // 6))
        cx, cy = int(rng.integers(r, w - r)), int(rng.integers(r, h - r))
        cv2.circle(img, (cx, cy), r, int(rng.integers(150, 250)), -1 if fill else 3)
    return img


# --- ops/threshold ----------------------------------------------------------


@pytest.mark.parametrize("mode", ["binary", "binary_inv", "trunc", "tozero", "tozero_inv"])
@pytest.mark.parametrize("thresh,maxval", [(127, 255), (0, 200), (254.7, 99)])
def test_threshold_modes_bitwise(mode, thresh, maxval):
    """jth.threshold ↔ tth.threshold: bitwise on uint8."""
    got = tth.threshold(_t(GRAY), thresh, maxval, mode).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jth.threshold(jnp.asarray(GRAY), thresh, maxval, mode)))


@pytest.mark.parametrize("img", ["gray", "frame", "flat"])
def test_threshold_otsu_equal(img):
    """jth.threshold_otsu ↔ tth.threshold_otsu: the same bin, as float32."""
    x = {"gray": GRAY, "frame": FRAME, "flat": np.full((20, 30), 77, np.uint8)}[img]
    got = tth.threshold_otsu(_t(x))
    assert got.dtype == torch.float32
    assert float(got) == float(jth.threshold_otsu(jnp.asarray(x)))


@pytest.mark.parametrize("method", ["mean", "gaussian"])
@pytest.mark.parametrize("mode", ["binary", "binary_inv"])
@pytest.mark.parametrize("block_size,c", [(11, 2.0), (7, -1.5), (21, 0.0)])
def test_adaptive_threshold_bitwise(method, mode, block_size, c):
    """jth.adaptive_threshold ↔ tth.adaptive_threshold: bitwise on the
    random image and on a demo frame (the local mean's half-even rounding
    included)."""
    for x in (GRAY, FRAME):
        got = tth.adaptive_threshold(_t(x), 255, method, mode, block_size, c).numpy()
        want = np.asarray(jth.adaptive_threshold(jnp.asarray(x), 255, method, mode, block_size, c))
        np.testing.assert_array_equal(got, want)


def test_in_range_and_mask_bitwise():
    """jth.in_range / bitwise_and_mask ↔ tth: bitwise."""
    lower, upper = (0, 50, 100), (120, 200, 255)
    got = tth.in_range(_t(IMG), lower, upper)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jth.in_range(jnp.asarray(IMG), lower, upper)))
    np.testing.assert_array_equal(tth.bitwise_and_mask(_t(IMG), got).numpy(),
                                  np.asarray(jth.bitwise_and_mask(jnp.asarray(IMG), jnp.asarray(got.numpy()))))


# --- ops/edges --------------------------------------------------------------


@pytest.mark.parametrize("border", ["reflect101", "replicate"])
def test_sobel_and_laplacian_bitwise(border):
    """jed.sobel ↔ ted.sobel (orders 0-2, ksize 1, 3, 5 and Scharr) and
    jed.laplacian ↔ ted.laplacian (ksize 1, 3): bitwise float32, on one
    image and on a [2, H, W] batch."""
    for x in (GRAY, np.stack([GRAY, FRAME[:72, :96]])):
        for dx, dy, ks in [(1, 0, 3), (0, 1, 3), (1, 0, -1), (0, 1, -1), (1, 0, 5), (2, 0, 5), (1, 1, 3), (1, 0, 1)]:
            np.testing.assert_array_equal(ted.sobel(_t(x), dx, dy, ks, border).numpy(),
                                          np.asarray(jed.sobel(jnp.asarray(x), dx, dy, ks, border)))
    for ks in (1, 3):
        np.testing.assert_array_equal(ted.laplacian(_t(GRAY), ks).numpy(), np.asarray(jed.laplacian(jnp.asarray(GRAY), ks)))


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("t1,t2", [(75, 200), (50, 100), (30, 200), (50.5, 100.25), (200, 75), (-5, 40)])
def test_canny_bitwise(l2, t1, t2):
    """jed.canny ↔ ted.canny, L1 and L2: bitwise on the blurred random image
    and on a demo frame, and on the two as one [2, H, W] batch."""
    a = cv2.GaussianBlur(GRAY, (5, 5), 0)
    b = FRAME[:72, :96]
    for x in (a, b, np.stack([a, b])):
        got = ted.canny(_t(x), t1, t2, l2gradient=l2).numpy()
        want = np.asarray(jed.canny(jnp.asarray(x), t1, t2, l2gradient=l2))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert (got > 0).any() or l2


@pytest.mark.parametrize("l2", [False, True])
@pytest.mark.parametrize("iters", [1, 64])
def test_canny_takes_hysteresis_iters(l2, iters):
    """jed.canny(..., hysteresis_iters=k) ↔ ted.canny(..., hysteresis_iters=k),
    bitwise: both accept the keyword and ignore it, running hysteresis to
    its fixpoint (on a demo frame whose weak chains take more than one
    step to grow, so k = 1 would differ were it read)."""
    x = cv2.GaussianBlur(FRAME, (3, 3), 0)
    got = ted.canny(_t(x), 20, 120, l2gradient=l2, hysteresis_iters=iters).numpy()
    want = np.asarray(jed.canny(jnp.asarray(x), 20, 120, l2gradient=l2, hysteresis_iters=iters))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ted.canny(_t(x), 20, 120, l2gradient=l2).numpy())


def test_canny_huge_threshold_is_clamped():
    """A threshold beyond int32 (where the JAX conversion overflows) is
    clamped, so it compares as the unbounded number would: above every
    magnitude no edge survives; below every magnitude the edges are those
    of threshold -1."""
    x = cv2.GaussianBlur(FRAME, (5, 5), 0)
    assert not ted.canny(_t(x), 1e12, 2e12).numpy().any()
    assert ted.canny(_t(x), 10, 20).numpy().any()
    assert not ted.canny(_t(x), 1e12, 2e12, l2gradient=True).numpy().any()
    np.testing.assert_array_equal(ted.canny(_t(x), -1e12, -1e12).numpy(), ted.canny(_t(x), -1, -1).numpy())


@pytest.mark.parametrize("shape", ["gray-u8", "bgr-u8", "gray-f32"])
def test_bilateral_within_one_code(shape):
    """jed.bilateral_filter ↔ ted.bilateral_filter(11, 17, 17): uint8 within
    1 code (torch's and XLA's float32 exp differ in the last bits), float32
    within 1e-4 relative."""
    x = {"gray-u8": GRAY, "bgr-u8": IMG[:40, :50], "gray-f32": GRAY.astype(np.float32) / 3.0}[shape]
    got = ted.bilateral_filter(_t(x), 11, 17, 17).numpy()
    want = np.asarray(jed.bilateral_filter(jnp.asarray(x), 11, 17, 17))
    assert got.dtype == want.dtype and got.shape == want.shape
    if x.dtype == np.uint8:
        assert np.abs(got.astype(np.int32) - want).max() <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4)


# --- ops/hough --------------------------------------------------------------


_HOUGH_CASES = {
    "2 discs, bounded radius": (lambda: cv2.circle(cv2.circle(np.full((160, 200), 40, np.uint8), (60, 70), 25, 220, -1),
                                                   (150, 90), 32, 200, -1),
                                dict(min_dist=50, acc_threshold=18.0, min_radius=15, max_radius=45)),
    "8 rings 240x320": (lambda: _circles(240, 320, 8, 1), dict(min_dist=20, acc_threshold=18.0)),
    "8 discs 180x320": (lambda: _circles(180, 320, 8, 4, fill=True), dict(acc_threshold=25.0, min_dist=20)),
    "demo frame": (lambda: FRAME, dict(acc_threshold=20.0, min_dist=20)),
    "noise": (lambda: cv2.GaussianBlur(np.random.default_rng(0).integers(0, 256, (90, 160)).astype(np.uint8),
                                       (5, 5), 0), dict(acc_threshold=30.0, min_dist=20)),
    "defaults": (lambda: _circles(120, 160, 3, 5), {}),
}


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("case", list(_HOUGH_CASES))
def test_hough_circles_same_circles(case, gate):
    """jho.hough_circles (jitted) ↔ tho.hough_circles(device="cpu"), gated
    and cv2-raw modes: the same circles in the same order, x, y and r within
    1e-3 px; and the fixed-size device form pads as the JAX one does."""
    make, kw = _HOUGH_CASES[case]
    img = make()
    want = jho.hough_circles(img, coherence_gate=gate, **kw)
    got = tho.hough_circles(img, coherence_gate=gate, device="cpu", **kw)
    assert got.dtype == np.float32 and got.shape == want.shape, (got, want)
    np.testing.assert_allclose(got, want, atol=1e-3)
    if case not in ("demo frame", "defaults", "noise"):
        assert len(want) >= 2
    circles, valid = tho.hough_circles_device(_t(img), coherence_gate=gate, max_circles=4, **kw)
    n = min(len(want), 4)
    assert circles.shape == (4, 3) and valid.tolist() == [True] * n + [False] * (4 - n)
    np.testing.assert_array_equal(circles[n:].numpy(), np.array([[-1e9, -1e9, 0]] * (4 - n), np.float32).reshape(-1, 3))


def test_detectcircles_cli_writes_what_jax_writes(tmp_path, monkeypatch, capsys):
    """jdc.main ↔ tdc.main (--device cpu) on an image of 8 rings, in both
    modes: stdout equal, the [input | annotated] PNG byte-equal. When the
    buffer fills, the JAX CLI prints its warning to stdout and the port the
    same line to stderr; the other lines are equal. Asked for cuda where there is
    none, the port raises."""
    from opticalflowclustering_tpu.cli import detectcircles as jdc
    from opticalflowclustering_tpu_torch.cli import detectcircles as tdc

    monkeypatch.chdir(tmp_path)
    cv2.imwrite("rings.png", cv2.cvtColor(_circles(240, 320, 8, 1), cv2.COLOR_GRAY2BGR))
    runs = [["--param2", "18", "--min-dist", "20"], ["--mode", "cv2-raw", "--param2", "18", "--min-dist", "20"],
            ["--param2", "18", "--min-dist", "20", "--max-circles", "3"]]
    for extra in runs:
        out = {}
        for side, main, dev in (("jax", jdc.main, []), ("port", tdc.main, ["--device", "cpu"])):
            assert main(["-i", "rings.png", "-o", f"{side}.png"] + extra + dev) == 0
            text = capsys.readouterr()
            out[side] = (text.out.replace(f"{side}.png", "<out>"), text.err)
        jax_lines = out["jax"][0].splitlines()
        full = jax_lines[0].startswith("warning: output buffer full")
        assert out["port"][1] == (jax_lines[0] + "\n" if full else "")
        jax_lines = jax_lines[full:]
        assert out["port"][0].splitlines() == jax_lines and "circle(s)" in jax_lines[-2]
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
    assert jax_lines[-2].startswith("3 circle(s)")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdc.main(["-i", "rings.png"])
