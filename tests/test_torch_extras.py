"""PyTorch port vs the JAX package: the nine extras workloads
(opticalflowclustering_tpu_torch.extras.{cluster_viz, compare_images,
histograms, compare_histograms, color_transfer, search_engine, detectors,
document_scanner, pokedex} ↔ opticalflowclustering_tpu.extras.*), on the
inputs of tests/test_extras.py's TestWorkloads and
tests/test_slic_overlays.py's cluster_viz case, made from a seed.

Integer outputs (histogram counts, masks, images, contours, boxes) are held
bitwise; float distances and descriptors to the rtol stated at each check;
color_transfer to the LAB gap the port inherits from ops.lab, with the count
of differing codes pinned."""

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.extras import cluster_viz as jcv
from opticalflowclustering_tpu.extras import color_transfer as jct
from opticalflowclustering_tpu.extras import compare_histograms as jch
from opticalflowclustering_tpu.extras import compare_images as jci
from opticalflowclustering_tpu.extras import detectors as jdet
from opticalflowclustering_tpu.extras import document_scanner as jds
from opticalflowclustering_tpu.extras import histograms as jhist
from opticalflowclustering_tpu.extras import pokedex as jpk
from opticalflowclustering_tpu.extras import search_engine as jse
from opticalflowclustering_tpu_torch.extras import cluster_viz as tcv
from opticalflowclustering_tpu_torch.extras import color_transfer as tct
from opticalflowclustering_tpu_torch.extras import compare_histograms as tch
from opticalflowclustering_tpu_torch.extras import compare_images as tci
from opticalflowclustering_tpu_torch.extras import detectors as tdet
from opticalflowclustering_tpu_torch.extras import document_scanner as tds
from opticalflowclustering_tpu_torch.extras import histograms as thist
from opticalflowclustering_tpu_torch.extras import pokedex as tpk
from opticalflowclustering_tpu_torch.extras import search_engine as tse

torch.set_num_threads(1)

CPU = "cpu"
RNG = np.random.default_rng(11)
IMG = RNG.integers(0, 256, size=(64, 80, 3), dtype=np.uint8)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_cluster_viz_equals_jax():
    """centroid_histogram and plot_colors on test_slic_overlays.py's labels
    and colours: equal arrays."""
    labels = np.array([0, 0, 1, 2, 2, 2])
    hist = tcv.centroid_histogram(labels)
    np.testing.assert_array_equal(hist, jcv.centroid_histogram(labels))
    cents = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]])
    np.testing.assert_array_equal(tcv.plot_colors(hist, cents), jcv.plot_colors(hist, cents))
    np.testing.assert_array_equal(tcv.centroid_histogram(np.zeros(0, int)), jcv.centroid_histogram(np.zeros(0, int)))


def test_compare_images_equals_jax():
    """(mse, ssim) of an image with itself and with a blurred copy: rtol
    1e-5 (float32 means reduced in another order)."""
    g = RNG.integers(0, 256, size=(48, 48), dtype=np.uint8)
    blurred = cv2.GaussianBlur(g, (5, 5), 1.2)
    for b in (g, blurred):
        got = tci.compare_images(g, b, device=CPU)
        want = jci.compare_images(g, b)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert tci.compare_images(g, g, device=CPU)[0] == 0.0


def test_histograms_equal_jax():
    """The four histogram workloads on the 64×80 test image: counts equal."""
    np.testing.assert_array_equal(thist.gray_histogram(IMG, device=CPU), jhist.gray_histogram(IMG))
    for a, b in zip(thist.channel_histograms(IMG, device=CPU), jhist.channel_histograms(IMG)):
        np.testing.assert_array_equal(a, b)
    got, want = thist.joint_histograms_2d(IMG, device=CPU), jhist.joint_histograms_2d(IMG)
    assert sorted(got) == sorted(want) == ["br", "gb", "gr"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(thist.flattened_3d_histogram(IMG, device=CPU), jhist.flattened_3d_histogram(IMG))


def test_compare_histograms_equal_jax():
    """describe (L2-normalized counts) within rtol 1e-6, and every entry of
    compare_all's table within rtol 1e-5 (atol 1e-6 for the zeros)."""
    h1, h2 = tch.describe(IMG, device=CPU), tch.describe(IMG[::-1, ::2], device=CPU)
    np.testing.assert_allclose(h1, jch.describe(IMG), rtol=1e-6)
    np.testing.assert_allclose(h2, jch.describe(IMG[::-1, ::2]), rtol=1e-6)
    got = tch.compare_all(h1, {"a": h1, "b": h2}, device=CPU)
    want = jch.compare_all(h1, {"a": h1, "b": h2})
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].keys() == want[name].keys()
        for m, v in want[name].items():
            np.testing.assert_allclose(got[name][m], v, rtol=1e-5, atol=1e-6, err_msg=f"{name} {m}")
    with pytest.raises(ValueError):
        tch.scipy_distance(h1, h2, "cosine", device=CPU)


def test_color_transfer_equals_jax_within_the_lab_gap():
    """color_transfer of the test's 40×40 source onto its 32×48 target: the
    same shape and dtype, and the BGR codes equal but for the pinned count
    of codes a float32 rounding (population std, LAB) moves by one step of
    the LAB round trip."""
    src = RNG.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)
    tar = RNG.integers(0, 256, size=(32, 48, 3), dtype=np.uint8)
    got = _np(tct.color_transfer(src, tar, device=CPU))
    want = np.asarray(jct.color_transfer(src, tar))
    assert got.shape == want.shape == tar.shape and got.dtype == want.dtype == np.uint8
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert int((gap > 0).sum()) == 0, (int((gap > 0).sum()), int(gap.max()))  # measured: none differ


def test_search_engine_equals_jax():
    """index_images (one batched call) within rtol 1e-6 of JAX's vmap, the
    describe feature within rtol 1e-6, and the ranking equal: the same
    names in the same order, distances within rtol 1e-5."""
    imgs = RNG.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    feats = tse.index_images(imgs, device=CPU)
    want = jse.index_images(imgs)
    assert feats.shape == want.shape == (6, 512) and feats.dtype == np.float32
    np.testing.assert_allclose(feats, want, rtol=1e-6, atol=1e-9)
    q = tse.RGBHistogram(device=CPU).describe(imgs[3])
    np.testing.assert_allclose(q, jse.RGBHistogram().describe(imgs[3]), rtol=1e-6, atol=1e-9)
    index = {f"img{i}": feats[i] for i in range(6)}
    got = tse.Searcher(index, device=CPU).search(q)
    ref = jse.Searcher(index).search(q)
    assert [n for _, n in got] == [n for _, n in ref] and got[0][1] == "img3" and got[0][0] < 1e-6
    np.testing.assert_allclose([d for d, _ in got], [d for d, _ in ref], rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tse.Searcher.chi2_distance(feats[0], feats[1], device=CPU),
                               jse.Searcher.chi2_distance(feats[0], feats[1]), rtol=1e-6)


def test_detect_colors_and_skin_equal_jax():
    """detect_colors' four masks and masked images and skin_mask's masked
    frame on the test image: equal."""
    got, want = tdet.detect_colors(IMG, device=CPU), jdet.detect_colors(IMG)
    assert len(got) == len(want) == 4
    for (gm, gi), (wm, wi) in zip(got, want):
        np.testing.assert_array_equal(_np(gm), np.asarray(wm))
        np.testing.assert_array_equal(_np(gi), np.asarray(wi))
    skin = RNG.integers(0, 256, size=(64, 80, 3), dtype=np.uint8)
    skin[10:50, 20:60] = (120, 150, 200)  # a skin-toned patch (hue ~10)
    for img in (IMG, skin):
        np.testing.assert_array_equal(_np(tdet.skin_mask(img, device=CPU)), np.asarray(jdet.skin_mask(img)))
    assert _np(tdet.skin_mask(skin, device=CPU)).any()


@pytest.mark.parametrize("radius", [0, 5])
def test_brightest_spot_equals_jax(radius):
    """The single-spot case of the test, and a tie (two equal maxima: the
    first in row-major order wins), naive and blurred: the same (x, y) and
    the same gray image (rtol 1e-6 after the blur)."""
    one = np.zeros((50, 70, 3), np.uint8)
    one[30, 55] = 255
    tie = one.copy()
    tie[12, 60] = 255
    for img in (one, tie):
        (xy, gray), (wxy, wgray) = tdet.brightest_spot(img, radius, device=CPU), jdet.brightest_spot(img, radius)
        assert xy == wxy
        np.testing.assert_allclose(_np(gray), np.asarray(wgray), rtol=1e-6, atol=1e-6)
    if radius == 0:
        assert tdet.brightest_spot(tie, device=CPU)[0] == (60, 12)


def test_locate_barcode_and_find_shapes_equal_jax():
    """The test's dense-bar image: locate_barcode's box equal; find_shapes'
    contours of the 30 bars (before the blur) equal."""
    bars = np.full((120, 200, 3), 255, np.uint8)
    for i in range(40, 160, 4):
        cv2.rectangle(bars, (i, 40), (i + 1, 90), (0, 0, 0), -1)
    img = cv2.GaussianBlur(bars, (3, 3), 0)
    box = tdet.locate_barcode(img, device=CPU)
    np.testing.assert_array_equal(box, jdet.locate_barcode(img))
    assert box.shape == (4, 2)
    got, want = tdet.find_shapes(bars, device=CPU), jdet.find_shapes(bars)
    assert len(got) == len(want) == 30
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    blank = np.full((40, 60, 3), 255, np.uint8)
    assert tdet.locate_barcode(blank, device=CPU).shape == jdet.locate_barcode(blank).shape == (0, 2)


def _document(h=240, w=200):
    img = np.full((h, w, 3), 30, np.uint8)
    quad = np.array([[40, 30], [160, 40], [150, 200], [30, 190]])
    cv2.fillPoly(img, [quad], (250, 250, 250))
    cv2.putText(img, "Doc", (70, 120), cv2.FONT_HERSHEY_SIMPLEX, 1, (0, 0, 0), 2)
    return img


def test_scan_document_equals_jax():
    """scan_document on the test's document image: the quad equal, the
    warped image and its binarization equal; no quad → (None, None)."""
    img = _document()
    np.testing.assert_array_equal(tds.find_document_contour(img, device=CPU), jds.find_document_contour(img))
    warped, binarized = tds.scan_document(img, height=240, device=CPU)
    w_want, b_want = jds.scan_document(img, height=240)
    np.testing.assert_array_equal(warped, w_want)
    np.testing.assert_array_equal(binarized, b_want)
    assert set(np.unique(binarized)) <= {0, 255}
    flat = np.full((60, 50, 3), 30, np.uint8)
    assert tds.scan_document(flat, height=60, device=CPU) == (None, None) == jds.scan_document(flat, height=60)


def test_pokedex_equals_jax():
    """The test's four sprites: sprite_outline equal, the Zernike
    descriptors within rtol 1e-5 (atol 1e-6), the same ranking; find_screen
    on the document image: the same rectified screen."""
    shapes = []
    for i in range(4):
        img = np.full((64, 64, 3), 255, np.uint8)
        if i % 2 == 0:
            cv2.circle(img, (32, 32), 8 + 4 * i, (0, 0, 0), -1)
        else:
            cv2.rectangle(img, (20, 20), (44 + i, 40), (0, 0, 0), -1)
        shapes.append(img)
    desc, jdesc = tpk.ZernikeMoments(radius=21, device=CPU), jpk.ZernikeMoments(radius=21)
    index, jindex = {}, {}
    for i, s in enumerate(shapes):
        outline = tpk.sprite_outline(255 - s, device=CPU)
        np.testing.assert_array_equal(outline, np.asarray(jpk.sprite_outline(255 - s)))
        index[f"s{i}"] = desc.describe(255 - outline)
        jindex[f"s{i}"] = jdesc.describe(255 - outline)
        np.testing.assert_allclose(index[f"s{i}"], jindex[f"s{i}"], rtol=1e-5, atol=1e-6)
    got = tpk.Searcher(index).search(index["s2"])
    want = jpk.Searcher(jindex).search(jindex["s2"])
    assert [n for _, n in got] == [n for _, n in want] and got[0][1] == "s2"
    screen = tpk.find_screen(_document(), width=200, device=CPU)
    np.testing.assert_array_equal(screen, jpk.find_screen(_document(), width=200))
    assert screen.ndim == 3
    np.testing.assert_array_equal(tpk.sprite_outline(np.zeros((8, 8, 3), np.uint8), device=CPU), np.zeros((8, 8)))


def test_extras_refuse_cuda_where_there_is_none():
    """Asking for the card where there is none raises, whatever the extra."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: tci.compare_images(IMG[..., 0], IMG[..., 0]), lambda: thist.gray_histogram(IMG),
                 lambda: tse.index_images(IMG[None]), lambda: tdet.skin_mask(IMG),
                 lambda: tds.scan_document(IMG), lambda: tpk.find_screen(IMG)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
