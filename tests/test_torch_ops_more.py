"""PyTorch port vs the JAX package: SSIM, SLIC with the superpixels CLI,
histograms, moments (raw, Hu, Zernike) and the geometric warps
(opticalflowclustering_tpu_torch.ops.ssim / .slic / .histogram / .moments /
.warp and .cli.superpixels ↔ the JAX modules of the same names).

Inputs are made with numpy from a seed, are frames of demo_out/601_3.avi,
or are drawn with cv2. The JAX ops run un-jitted except `slic`. Held to:
SSIM and Zernike rtol 1e-5, the moments rtol 1e-5 of the size of their
terms (float32 sums in another order); histogram counts bitwise, the
comparisons rtol 1e-6; the warp matrices rtol 1e-12 and the warped images
bitwise (resize_aspect within 1 code); SLIC labels equal on piecewise-flat
images and on ≥ 99.9% of the pixels of real frames (measured here: all of
them)."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.io.video import read_video_bgr
from opticalflowclustering_tpu.ops import histogram as jhi
from opticalflowclustering_tpu.ops import moments as jmo
from opticalflowclustering_tpu.ops import slic as jsl
from opticalflowclustering_tpu.ops import ssim as jss
from opticalflowclustering_tpu.ops import warp as jwa
from opticalflowclustering_tpu_torch.ops import histogram as thi
from opticalflowclustering_tpu_torch.ops import moments as tmo
from opticalflowclustering_tpu_torch.ops import slic as tsl
from opticalflowclustering_tpu_torch.ops import ssim as tss
from opticalflowclustering_tpu_torch.ops import warp as twa

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
RNG = np.random.default_rng(9)
IMG = RNG.integers(0, 256, size=(72, 96, 3), dtype=np.uint8)
GRAY = cv2.cvtColor(IMG, cv2.COLOR_BGR2GRAY)
FRAMES = read_video_bgr(DEMO, 60)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- ops/ssim ---------------------------------------------------------------


@pytest.mark.parametrize("pair", ["blurred", "frames", "identical", "batch"])
def test_mse_and_ssim_rtol(pair):
    """jss.mse / ssim ↔ tss: rtol 1e-5."""
    f = cv2.cvtColor(FRAMES[20], cv2.COLOR_BGR2GRAY)
    a, b = {
        "blurred": (GRAY, cv2.GaussianBlur(GRAY, (5, 5), 1.2)),
        "frames": (f, cv2.cvtColor(FRAMES[24], cv2.COLOR_BGR2GRAY)),
        "identical": (f, f),
        "batch": (np.stack([GRAY, GRAY[::-1]]), np.stack([cv2.GaussianBlur(GRAY, (3, 3), 0), GRAY])),
    }[pair]
    np.testing.assert_allclose(float(tss.mse(_t(a), _t(b))), float(jss.mse(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    got = float(tss.ssim(_t(a), _t(b)))
    np.testing.assert_allclose(got, float(jss.ssim(jnp.asarray(a), jnp.asarray(b))), rtol=1e-5)
    assert (got == pytest.approx(1.0, abs=1e-5)) == (pair == "identical")


# --- ops/slic and the superpixels CLI ---------------------------------------


def _blocks():
    img = np.zeros((60, 90, 3), np.uint8)
    img[:, :30] = (200, 40, 40)
    img[:, 30:60] = (40, 200, 40)
    img[:, 60:] = (40, 40, 200)
    return img


@pytest.mark.parametrize("case", ["blocks", "blocks-sigma", "frame-100", "frame-200", "frame-300", "noise"])
def test_slic_labels(case):
    """jsl.slic ↔ tsl.slic: labels equal on the piecewise-flat colour
    blocks (tests/test_slic_overlays.py), and on ≥ 99.9% of the pixels of
    demo frames and of seeded noise; mark_boundaries of the same labels
    bitwise."""
    img, kw = {
        "blocks": (_blocks(), dict(n_segments=24, sigma=0.0)),
        "blocks-sigma": (_blocks(), dict(n_segments=12, sigma=1.0)),
        "frame-100": (FRAMES[10], {}),
        "frame-200": (FRAMES[40], dict(n_segments=200)),
        "frame-300": (FRAMES[59], dict(n_segments=300, compactness=20.0, n_iter=5)),
        "noise": (RNG.integers(0, 256, (64, 64, 3), dtype=np.uint8), dict(n_segments=16, sigma=1.0)),
    }[case]
    want = np.asarray(jsl.slic(img, **kw))
    got = tsl.slic(_t(img), **kw)
    assert got.dtype == torch.int32 and tuple(got.shape) == img.shape[:2]
    got = got.numpy()
    if case.startswith("blocks"):
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() >= 0.999
    np.testing.assert_array_equal(tsl.mark_boundaries(_t(img), _t(want)).numpy(),
                                  np.asarray(jsl.mark_boundaries(jnp.asarray(img), jnp.asarray(want))))


@pytest.mark.parametrize("image", ["blocks", "frame"])
def test_superpixels_cli_writes_what_jax_writes(tmp_path, monkeypatch, capsys, image):
    """jsp.main ↔ tsp.main (--device cpu): stdout equal and each overlay PNG
    equal where the two sides' labels are (byte-equal where all are);
    asked for cuda where there is none, the port raises."""
    from opticalflowclustering_tpu.cli import superpixels as jsp
    from opticalflowclustering_tpu_torch.cli import superpixels as tsp

    img = _blocks() if image == "blocks" else FRAMES[30]
    monkeypatch.chdir(tmp_path)
    cv2.imwrite("in.png", img)
    segs = ["12", "24"] if image == "blocks" else ["50", "100"]
    out = {}
    for side, main, extra in (("jax", jsp.main, []), ("port", tsp.main, ["--device", "cpu"])):
        main(["-i", "in.png", "-o", side, "--segments", *segs] + extra)
        out[side] = capsys.readouterr().out.replace(side, "<out>")
    assert out["port"] == out["jax"] and out["port"].count("segments") == 2
    for n in segs:
        want_labels = np.asarray(jsl.slic(img, n_segments=int(n), sigma=5.0))
        got_labels = tsl.slic(_t(img), n_segments=int(n), sigma=5.0).numpy()
        same = (got_labels == want_labels)
        same[1:] &= same[:-1]
        same[:, 1:] &= same[:, :-1]
        a, b = cv2.imread(f"port_{n}.png"), cv2.imread(f"jax_{n}.png")
        np.testing.assert_array_equal(a[same], b[same])
        if same.all():
            assert (tmp_path / f"port_{n}.png").read_bytes() == (tmp_path / f"jax_{n}.png").read_bytes()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tsp.main(["-i", "in.png", "--segments", "4"])


# --- ops/histogram ----------------------------------------------------------


@pytest.mark.parametrize("case", ["1d", "2d", "3d-masked", "ranges", "frame-3d"])
def test_calc_hist_counts_bitwise(case):
    """jhi.calc_hist ↔ thi.calc_hist: float32 counts bitwise (the JAX one-hot
    branch below 2^24 elements, its scatter branch above: frame-3d)."""
    mask = np.zeros(IMG.shape[:2], np.uint8)
    mask[10:50, 20:70] = 255
    img, args, m = {
        "1d": (IMG, ([1], [256], [(0, 256)]), None),
        "2d": (IMG, ([1, 0], [32, 32], [(0, 256), (0, 256)]), None),
        "3d-masked": (IMG, ([0, 1, 2], [8, 8, 8], [(0, 256)] * 3), mask),
        "ranges": (IMG, ([2, 0], [10, 7], [(20, 200), (0, 180)]), None),
        "frame-3d": (np.concatenate([FRAMES[5]] * 4), ([0, 1, 2], [32, 32, 32], [(0, 256)] * 3), None),
    }[case]
    want = np.asarray(jhi.calc_hist(jnp.asarray(img), *args, mask=None if m is None else jnp.asarray(m)))
    got = thi.calc_hist(_t(img), *args, mask=None if m is None else _t(m)).numpy()
    assert got.dtype == np.float32 and got.shape == tuple(args[1])
    np.testing.assert_array_equal(got, want)


def test_histogram_comparisons_rtol():
    """jhi.normalize_l2 / compare_hist (4 methods) / chi2_distance /
    rgb_histogram_feature ↔ thi: rtol 1e-6."""
    h1 = jhi.calc_hist(jnp.asarray(IMG), [0], [64], [(0, 256)])
    h2 = jhi.calc_hist(jnp.asarray(IMG[::-1]), [1], [64], [(0, 256)])
    t1, t2 = _t(np.asarray(h1)), _t(np.asarray(h2))
    for method in ("correl", "chisqr", "intersect", "bhattacharyya"):
        np.testing.assert_allclose(float(thi.compare_hist(t1, t2, method)), float(jhi.compare_hist(h1, h2, method)),
                                   rtol=1e-6, err_msg=method)
    np.testing.assert_allclose(thi.normalize_l2(t1).numpy(), np.asarray(jhi.normalize_l2(h1)), rtol=1e-6)
    a, b = RNG.random((3, 512)).astype(np.float32), RNG.random((3, 512)).astype(np.float32)
    np.testing.assert_allclose(thi.chi2_distance(_t(a), _t(b)).numpy(), np.asarray(jhi.chi2_distance(a, b)), rtol=1e-6)
    np.testing.assert_allclose(thi.rgb_histogram_feature(_t(IMG)).numpy(),
                               np.asarray(jhi.rgb_histogram_feature(jnp.asarray(IMG))), rtol=1e-6)
    zero = torch.zeros(8)
    assert float(thi.compare_hist(zero, zero, "correl")) == float(jhi.compare_hist(np.zeros(8), np.zeros(8), "correl"))


# --- ops/moments ------------------------------------------------------------


def _term_scale(x, key):
    """Σ |f·dx^p·dy^q| in float64 for moment `key` (m/mu/nu pq), the dx, dy
    raw for m and about the centroid for mu and nu, nu divided by
    m00^(1+(p+q)/2): the size of the terms a float32 sum of that moment
    adds, which bounds its rounding where the terms cancel."""
    x = x.astype(np.float64)
    p, q = int(key[-2]), int(key[-1])
    ys, xs = np.arange(x.shape[-2])[:, None], np.arange(x.shape[-1])[None, :]
    m00 = x.sum((-2, -1), keepdims=True)
    if key.startswith(("mu", "nu")):
        xs = xs - (x * xs).sum((-2, -1), keepdims=True) / m00
        ys = ys - (x * ys).sum((-2, -1), keepdims=True) / m00
    s = (x * np.abs(xs) ** p * np.abs(ys) ** q).sum((-2, -1))
    return s / m00[..., 0, 0] ** (1 + (p + q) / 2) if key.startswith("nu") else s


@pytest.mark.parametrize("img", ["gray", "frame", "float64", "batch"])
def test_moments_and_hu_rtol(img):
    """jmo.moments (every key) / hu_moments ↔ tmo: rtol 1e-5 of the terms'
    size (the two float32 sums add in different orders, and the central
    moments of a noise image cancel to ~1e-5 of their terms: measured
    ≤ 7.6e-7 of it); Hu within 1e-5 of the first invariant. JAX computes a
    float64 image in float32 (x64 is off), the port in float64."""
    f = cv2.cvtColor(FRAMES[33], cv2.COLOR_BGR2GRAY)
    x = {"gray": GRAY, "frame": f, "float64": GRAY.astype(np.float64) / 7.0,
         "batch": np.stack([GRAY, f[:72, :96]])}[img]
    want, got = jmo.moments(jnp.asarray(x)), tmo.moments(_t(x))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == (torch.float64 if img == "float64" else torch.float32), k
        np.testing.assert_array_less(np.abs(got[k].numpy() - np.asarray(want[k])), 1e-5 * _term_scale(x, k) + 1e-30)
    hu_want = np.asarray(jmo.hu_moments(jnp.asarray(x)))
    np.testing.assert_allclose(tmo.hu_moments(_t(x)).numpy(), hu_want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(hu_want[..., 0]).min()))
    if img == "frame":  # no cancellation on a real frame: plain rtol 1e-5
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("degree", [8, 12])
def test_zernike_rtol(degree):
    """jmo.zernike_moments ↔ tmo.zernike_moments: rtol 1e-5 (atol 1e-6 for
    the moments near 0) on a rectangle, a circle, a demo frame and a batch."""
    rect = np.zeros((64, 64), np.uint8)
    cv2.rectangle(rect, (20, 26), (44, 38), 255, -1)
    circ = np.zeros((64, 64), np.uint8)
    cv2.circle(circ, (36, 28), 10, 255, -1)
    frame = cv2.cvtColor(FRAMES[45], cv2.COLOR_BGR2GRAY)[:64, :64]
    for x in (rect, circ, frame, np.stack([rect, circ])):
        want = np.asarray(jmo.zernike_moments(jnp.asarray(x), 21, degree))
        got = tmo.zernike_moments(_t(x), 21, degree).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# --- ops/warp ---------------------------------------------------------------


def test_warp_matrices_rtol():
    """get_rotation_matrix_2d / get_perspective_transform / order_points ↔
    the JAX package's: rtol 1e-12 (host float64 on both sides)."""
    np.testing.assert_allclose(twa.get_rotation_matrix_2d((45.0, 30.0), 33.0, 1.2),
                               jwa.get_rotation_matrix_2d((45.0, 30.0), 33.0, 1.2), rtol=1e-12)
    src = np.float32([[10, 10], [80, 12], [85, 60], [5, 55]])
    dst = np.float32([[0, 0], [100, 0], [100, 50], [0, 50]])
    np.testing.assert_allclose(twa.get_perspective_transform(src, dst), jwa.get_perspective_transform(src, dst),
                               rtol=1e-12)
    np.testing.assert_array_equal(twa.order_points(src[[2, 0, 3, 1]]), jwa.order_points(src[[2, 0, 3, 1]]))


@pytest.mark.parametrize("img", ["bgr", "gray", "float"])
def test_warped_images_bitwise(img):
    """warp_affine, warp_perspective, four_point_transform, translate and
    rotate ↔ the JAX package's: bitwise, uint8 BGR and gray and float32.
    resize_aspect goes through resize_linear's banded matmul, whose float32
    sums differ in the last bit (tests/test_torch_ops.py): within 1 code
    for uint8 (measured: 1 pixel of 9,900), rtol 1e-6 for float32."""
    x = {"bgr": IMG, "gray": GRAY, "float": IMG.astype(np.float32) / 3.0}[img]
    m_aff = jwa.get_rotation_matrix_2d((48.0, 36.0), 20.0, 0.9)
    src = np.float32([[10, 10], [80, 12], [85, 60], [5, 55]])
    m_per = jwa.get_perspective_transform(src, np.float32([[0, 0], [95, 0], [95, 71], [0, 71]]))
    quad = np.array([[12, 8], [80, 15], [78, 60], [8, 55]], np.float32)
    cases = [
        (lambda f, a: f.warp_affine(a, m_aff, (96, 72)), "warp_affine"),
        (lambda f, a: f.warp_affine(a, m_aff, (50, 40)), "warp_affine smaller"),
        (lambda f, a: f.warp_perspective(a, m_per, (96, 72)), "warp_perspective"),
        (lambda f, a: f.four_point_transform(a, quad), "four_point_transform"),
        (lambda f, a: f.translate(a, 5, -3), "translate"),
        (lambda f, a: f.rotate(a, 45), "rotate"),
        (lambda f, a: f.resize_aspect(a, width=48), "resize_aspect width"),
        (lambda f, a: f.resize_aspect(a, height=50), "resize_aspect height"),
    ]
    for run, name in cases:
        want = np.asarray(run(jwa, jnp.asarray(x)))
        got = run(twa, _t(x)).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if not name.startswith("resize_aspect"):
            np.testing.assert_array_equal(got, want, err_msg=name)
        elif img == "float":
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
        else:
            assert np.abs(got.astype(np.int32) - want).max() <= 1, name
