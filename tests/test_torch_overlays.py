"""PyTorch port vs the JAX package: morphology, the contour helpers and
fill_poly_mask, the YOLO/contour overlays, the overlay path of the bounce
pipeline and of the kmeangrids CLI
(opticalflowclustering_tpu_torch.ops.morphology / .extras.contours /
.io.overlays / .pipeline.bounce / .cli ↔ the JAX modules of the same names).

Inputs are made with numpy from a seed, or are the first frames of
demo_out/601_3.avi. Everything here is integer or uint8, or float32 in one
fixed operation order, and is held bitwise; the contour helpers are host
numpy on both sides and are held equal."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.extras import contours as jct
from opticalflowclustering_tpu.io import overlays as jov
from opticalflowclustering_tpu.io.video import read_video_bgr
from opticalflowclustering_tpu.ops import morphology as jmo
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.extras import contours as tct
from opticalflowclustering_tpu_torch.io import overlays as tov
from opticalflowclustering_tpu_torch.ops import morphology as tmo
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
RNG = np.random.default_rng(9)
IMG = RNG.integers(0, 256, size=(72, 96, 3), dtype=np.uint8)
GRAY = IMG[..., 1].copy()


def _t(a):
    return torch.from_numpy(np.array(a))


# --- ops/morphology ---------------------------------------------------------


@pytest.mark.parametrize("shape", ["rect", "cross", "ellipse"])
def test_structuring_element_equals_jax(shape):
    """jmo.structuring_element ↔ tmo.structuring_element: equal at the sizes
    tests/test_ops_extras.py checks against cv2, and at 1×1 and 5×5."""
    for ks in [(3, 3), (9, 3), (21, 7), (11, 11), (1, 1), (5, 5)]:
        np.testing.assert_array_equal(tmo.structuring_element(shape, ks), jmo.structuring_element(shape, ks))


@pytest.mark.parametrize("shape,ks,iters", [("ellipse", (9, 11), 2), ("ellipse", (9, 11), 3),
                                            ("rect", (21, 7), 1), ("cross", (5, 5), 2), ("rect", (5, 5), 1)])
def test_erode_dilate_bitwise(shape, ks, iters):
    """jmo.erode / dilate ↔ tmo: bitwise on uint8, on one frame and on a
    [2, H, W] batch (replicate border, rect as two 1-D passes)."""
    k = jmo.structuring_element(shape, ks)
    for x in (GRAY, np.stack([GRAY, 255 - GRAY])):
        for j, t in ((jmo.erode, tmo.erode), (jmo.dilate, tmo.dilate)):
            got = t(_t(x), k, iters).numpy()
            assert got.dtype == np.uint8
            np.testing.assert_array_equal(got, np.asarray(j(jnp.asarray(x), k, iters)))


@pytest.mark.parametrize("op", ["open", "close", "gradient", "tophat", "blackhat"])
@pytest.mark.parametrize("shape,ks", [("rect", (21, 7)), ("ellipse", (9, 11))])
def test_morphology_ex_bitwise(op, shape, ks):
    """jmo.morphology_ex ↔ tmo.morphology_ex: bitwise on uint8 (the barcode
    kernel of tests/test_ops_extras.py and an ellipse)."""
    k = jmo.structuring_element(shape, ks)
    np.testing.assert_array_equal(tmo.morphology_ex(_t(GRAY), op, k).numpy(),
                                  np.asarray(jmo.morphology_ex(jnp.asarray(GRAY), op, k)))


# --- extras/contours --------------------------------------------------------


def _star(rng, n, cx, cy, r0, r1):
    """A star-shaped polygon of n vertices (concave, integer coordinates)."""
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    r = rng.uniform(r0, r1, n)
    return np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1).round().astype(np.int64)


def _polygon_sets():
    rng = np.random.default_rng(3)
    return {
        "quad": [np.array([[10, 10], [60, 15], [55, 45], [12, 40]])],
        "star-50": [_star(rng, 50, 70, 50, 8, 40)],
        "star-300": [_star(rng, 300, 80, 60, 5, 55)],
        "two-overlapping": [_star(rng, 120, 50, 50, 10, 35), _star(rng, 80, 80, 60, 10, 30)],
        "self-intersecting": [np.array([[5, 5], [100, 80], [100, 5], [5, 80]])],
        "off-frame": [np.array([[-20, -10], [200, 30], [150, 140], [-5, 100]])],
        "horizontal-edges": [np.array([[10, 20], [40, 20], [40, 60], [70, 60], [70, 90], [10, 90]])],
        "degenerate": [np.array([[30, 30]]), np.array([[5, 5], [50, 5]])],
        "none": [],
    }


@pytest.mark.parametrize("name", list(_polygon_sets()))
def test_fill_poly_mask_bitwise(name):
    """jct.fill_poly_mask ↔ tct.fill_poly_mask (device "cpu"): bitwise on a
    120×160 frame, for polygons of 1 to 300 vertices, concave,
    self-intersecting, overlapping, partly off the frame, with horizontal
    edges, and for none."""
    polys = _polygon_sets()[name]
    want = np.asarray(jct.fill_poly_mask((120, 160), polys))
    got = tct.fill_poly_mask((120, 160), polys, "cpu").numpy()
    assert got.dtype == np.uint8 and got.shape == (120, 160)
    np.testing.assert_array_equal(got, want)
    assert name in ("degenerate", "none") or want.any()


def test_contour_host_helpers_equal_jax():
    """The host helpers (find_external_contours, contour_area, arc_length,
    approx_poly_dp, bounding_rect, convex_hull, min_area_rect, box_points)
    ↔ the JAX package's: equal on the masks of tests/test_extras.py's
    contour cases and on a filled star."""
    import cv2

    masks = []
    for rect in (((10, 15), (49, 44)), ((10, 15), (60, 50))):
        m = np.zeros((60, 80), np.uint8)
        cv2.rectangle(m, *rect, 255, -1)
        masks.append(m)
    m = np.zeros((80, 80), np.uint8)
    cv2.fillPoly(m, [cv2.boxPoints(((40, 40), (30, 16), 25.0)).astype(np.int32)], 255)
    masks.append(m)
    masks.append(np.asarray(jct.fill_poly_mask((90, 120), [_star(np.random.default_rng(5), 60, 60, 45, 10, 40)])))
    for m in masks:
        want, got = jct.find_external_contours(m), tct.find_external_contours(m)
        assert len(got) == len(want) >= 1
        for c, cj in zip(got, want):
            np.testing.assert_array_equal(c, cj)
            assert tct.contour_area(c) == jct.contour_area(c)
            assert tct.arc_length(c) == jct.arc_length(c) and tct.arc_length(c, False) == jct.arc_length(c, False)
            for closed in (True, False):
                np.testing.assert_array_equal(tct.approx_poly_dp(c, 0.02 * jct.arc_length(c), closed),
                                              jct.approx_poly_dp(c, 0.02 * jct.arc_length(c), closed))
            assert tct.bounding_rect(c) == jct.bounding_rect(c)
            np.testing.assert_array_equal(tct.convex_hull(c), jct.convex_hull(c))
            rect = tct.min_area_rect(c)
            assert rect == jct.min_area_rect(c)
            np.testing.assert_array_equal(tct.box_points(rect), jct.box_points(rect))


# --- io/overlays ------------------------------------------------------------


def _write_overlay_inputs(root, video_name, frames, h, w, seed=0):
    """yolo_labels.txt with boxes on about a third of `frames` (some cut by
    the frame edge) and Contours/<video>/<video>_<n>.txt with 1-2 polygons of
    50-300 vertices on about a third, under `root`."""
    rng = np.random.default_rng(seed)
    rows = []
    for f in frames:
        if f % 3 == 0:
            for _ in range(rng.integers(1, 3)):
                row = np.zeros(11)
                row[0] = f
                row[1:3] = rng.uniform(0, 1, 2)
                row[3:7] = (rng.integers(-5, w), rng.integers(-5, h), rng.integers(3, w // 2), rng.integers(3, h // 2))
                row[7:] = rng.uniform(0, 1, 4)
                rows.append(row)
    np.savetxt(root / "yolo_labels.txt", np.array(rows))
    d = root / "Contours" / video_name
    d.mkdir(parents=True)
    for f in frames:
        if f % 3 == 1:
            lines = []
            for k in range(rng.integers(1, 3)):
                poly = _star(rng, int(rng.integers(50, 301)), rng.integers(0, w), rng.integers(0, h), 3, min(h, w) / 2)
                lines.append(" ".join(map(str, [k, *poly.ravel()])))
            (d / f"{video_name}_{f}.txt").write_text("\n".join(lines) + "\n")


def test_overlay_readers_and_edits_bitwise(tmp_path):
    """jov.load_yolo_boxes / yolo_rects_for_frame / load_contour_polys ↔
    tov: equal; draw_rect_outline and apply_contour_mask ↔ tov on a numpy
    frame and on a tensor: frames bitwise equal."""
    _write_overlay_inputs(tmp_path, "v.avi", range(2, 14), 60, 80)
    data = tov.load_yolo_boxes(str(tmp_path / "yolo_labels.txt"))
    np.testing.assert_array_equal(data, jov.load_yolo_boxes(str(tmp_path / "yolo_labels.txt")))
    n_rects = n_polys = 0
    for f in range(2, 14):
        rects = tov.yolo_rects_for_frame(data, f)
        np.testing.assert_array_equal(rects, jov.yolo_rects_for_frame(data, f))
        polys = tov.load_contour_polys(str(tmp_path / "Contours"), "v.avi", f)
        want_polys = jov.load_contour_polys(str(tmp_path / "Contours"), "v.avi", f)
        assert len(polys) == len(want_polys)
        for p, q in zip(polys, want_polys):
            np.testing.assert_array_equal(p, q)
        want = RNG.integers(0, 256, (60, 80, 3), dtype=np.uint8)
        on_host, on_tensor = want.copy(), _t(want.copy())
        for x, y, w, h in rects:
            jov.draw_rect_outline(want, x, y, w, h)
            tov.draw_rect_outline(on_host, x, y, w, h)
            tov.draw_rect_outline(on_tensor, x, y, w, h)
        jov.apply_contour_mask(want, want_polys)
        tov.apply_contour_mask(on_host, polys)
        tov.apply_contour_mask(on_tensor, polys)
        np.testing.assert_array_equal(on_host, want)
        np.testing.assert_array_equal(on_tensor.numpy(), want)
        n_rects += len(rects)
        n_polys += len(polys)
    assert n_rects >= 4 and n_polys >= 4
    assert tov.load_contour_polys(str(tmp_path / "Contours"), "v.avi", 99) == []


# --- pipeline/bounce overlay path and the CLIs ------------------------------


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("which", ["both", "yolo", "contours"])
def test_process_frames_overlays_bitwise(tmp_path, mode, which):
    """jpl.process_frames(overlays=OverlaySpec) ↔ tpl.process_frames(...,
    "cpu", overlays=OverlaySpec) on 7 frames of the demo clip at chunk 4 (a
    padded tail chunk): flow_bgr, hue_table, rgb_hue_table, centroids and
    mean_magnitude bitwise equal, in exact and fast; and they differ from
    the run without overlays where a frame has one."""
    frames = read_video_bgr(DEMO, 7)
    _write_overlay_inputs(tmp_path, "clip.avi", range(2, 8), *frames.shape[1:3], seed=1)
    kw = {"yolo_file": str(tmp_path / "yolo_labels.txt") if which != "contours" else None,
          "contour_dir": str(tmp_path / "Contours") if which != "yolo" else None, "video_name": "clip.avi"}
    cfg = jpl.PipelineConfig(chunk=4, emit_flow_bgr=False, flow=jpl.FarnebackParams(warp_mode=mode))
    want = {k: np.asarray(v) for k, v in jpl.process_frames(frames, cfg, overlays=jpl.OverlaySpec(**kw)).items()}
    got = tpl.process_frames(frames, from_jax_config(cfg), "cpu", overlays=tpl.OverlaySpec(**kw))
    assert sorted(got) == sorted(want) == ["centroids", "flow_bgr", "hue_table", "mean_magnitude", "rgb_hue_table"]
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape == (6,) + v.shape[1:], k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    plain = tpl.process_frames(frames, from_jax_config(cfg), "cpu")
    drawn = [f - 2 for f in range(2, 8) if (f % 3 == 0 and which != "contours") or (f % 3 == 1 and which != "yolo")]
    assert "flow_bgr" not in plain
    for i in range(6):
        assert np.array_equal(plain["centroids"][i], got["centroids"][i]) == (i not in drawn), i


def test_kmeangrids_cli_overlays_by_default_writes_what_jax_writes(tmp_path, monkeypatch, capsys):
    """jkg.main ↔ tkg.main (--device cpu) called as the reference's users
    call it, without --noyolo --nocontour (overlays on), on 9 frames of the
    demo clip with the yolo_labels.txt and Contours/ that the test writes in
    each working directory: OutCSV/601_3.csv, the -f rows and the printed
    line byte-equal; the overlays changed the -f rows."""
    from opticalflowclustering_tpu.cli import kmeangrids as jkg
    from opticalflowclustering_tpu_torch.cli import kmeangrids as tkg

    out = {}
    for side, main in (("jax", jkg.main), ("port", tkg.main)):
        d = tmp_path / side
        d.mkdir()
        _write_overlay_inputs(d, "601_3.avi", range(2, 10), 232, 220, seed=2)
        monkeypatch.chdir(d)
        main(["-d", "OutImgs/601_3", "-c", "1", "-f", "addnew.csv", "--path", DEMO, "--max-frames", "9"]
             + (["--device", "cpu"] if side == "port" else []))
        out[side] = (capsys.readouterr().out, (d / "OutCSV" / "601_3.csv").read_bytes(),
                     (d / "addnew.csv").read_bytes())
    assert out["port"] == out["jax"]
    plain = tpl.process_frames(read_video_bgr(DEMO, 9), tpl.PipelineConfig(emit_flow_bgr=False), "cpu")
    table = np.loadtxt(tmp_path / "port" / "OutCSV" / "601_3.csv", delimiter=",", skiprows=1, dtype=np.int64)
    assert table.shape == (8, 350) and out["port"][2].count(b"\n") == 8 * 350
    assert out["port"][2] != _addnew_rows(plain, tmp_path)



def _addnew_rows(out, tmp_path):
    """The -f rows the CLI writes for the tables `out`."""
    from opticalflowclustering_tpu_torch.compat.writers import append_cluster_centers_rows

    path = tmp_path / "plain_addnew.csv"
    hue = out["hue_table"]
    names = [f"{f}/{c + 1}.png" for f in range(2, 2 + hue.shape[0]) for c in range(hue.shape[1])]
    append_cluster_centers_rows(str(path), names=names, centroids=out["centroids"].reshape(-1, 4),
                                hues=hue.reshape(-1))
    return path.read_bytes()
