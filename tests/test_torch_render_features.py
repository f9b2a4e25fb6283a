"""PyTorch port vs the JAX package given the same inputs: the flow render,
the grid features, the matcher and the CSV writers
(opticalflowclustering_tpu_torch.{flow.render, features, cluster.matcher,
pipeline.bounce.dominant_hue_series/classify_bounce, compat.writers} ↔ the
same functions of opticalflowclustering_tpu).

Given the same flow, every uint8/int32 table is bitwise equal; the JAX
functions run un-jitted for those checks."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cluster.matcher import match_signature as j_match
from opticalflowclustering_tpu.compat import writers as jwr
from opticalflowclustering_tpu.features.dominant_color import (
    dominant_hue_k1_frames as j_dominant,
)
from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.features.grid import grid_mean_hue as j_grid_mean_hue
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.flow.farneback import farneback_flow as j_flow
from opticalflowclustering_tpu.flow.render import render_flow_hsv_bgr as j_render
from opticalflowclustering_tpu.io.video import read_video_bgr
from opticalflowclustering_tpu.ops.colorspace import bgr2gray as j_gray
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu_torch.cluster.matcher import match_signature as t_match
from opticalflowclustering_tpu_torch.compat import writers as twr
from opticalflowclustering_tpu_torch.features.dominant_color import (
    dominant_hue_k1_frames as t_dominant,
)
from opticalflowclustering_tpu_torch.features.grid import GridParams as TGrid
from opticalflowclustering_tpu_torch.features.grid import grid_mean_hue as t_grid_mean_hue
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr as t_render
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

DEMO = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "demo_out", "601_3.avi"
)


@pytest.fixture(scope="module")
def demo9():
    return read_video_bgr(DEMO, 9)


def test_render_and_features_bitwise_given_jax_flow(demo9):
    """Given JAX's flow: j_render ↔ t_render, j_dominant ↔ t_dominant (both
    rb_swap settings), j_grid_mean_hue ↔ t_grid_mean_hue are bitwise equal."""
    gray = np.asarray(j_gray(demo9[:5]))
    flow = np.array(jax.jit(lambda a, b: j_flow(a, b, JFlow(warp_mode="fast")))(gray[:-1], gray[1:]))
    flow[0, :8, :8] = 0.0  # exact zeros: the 0-angle, 0-magnitude corner
    want_bgr = np.asarray(j_render(flow))
    got_bgr = t_render(torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(got_bgr, want_bgr)
    for rb_swap in (True, False):
        jc, jh = j_dominant(want_bgr, JGrid(), rb_swap=rb_swap)
        tc, th = t_dominant(torch.from_numpy(got_bgr), TGrid(), rb_swap=rb_swap)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        assert tc.dtype == torch.int32 and th.dtype == torch.uint8
    np.testing.assert_array_equal(
        t_grid_mean_hue(torch.from_numpy(got_bgr), TGrid()).numpy(),
        np.asarray(j_grid_mean_hue(want_bgr, JGrid())),
    )


def test_dominant_hue_series_and_classify_bounce(demo9):
    """jpl.dominant_hue_series ↔ tpl.dominant_hue_series (bitwise), and
    j_match ↔ t_match / tpl.classify_bounce, including the last-tie-wins
    rule on a series with repeated windows."""
    jc, jh = jpl.dominant_hue_series(demo9)
    tc, th = tpl.dominant_hue_series(demo9, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))

    rng = np.random.default_rng(6)
    series = rng.integers(0, 180, 60).astype(np.float32)
    series[40:45] = series[10:15]  # an exact repeat: the later window wins
    series[50:55] = 0.0  # zero-norm windows score 0
    for sig in (series[10:15], rng.integers(0, 180, 7).astype(np.float32)):
        js, jf = j_match(jnp.asarray(sig), jnp.asarray(series))
        ts, tf = t_match(torch.from_numpy(sig), torch.from_numpy(series))
        assert int(tf) == int(jf)
        np.testing.assert_allclose(float(ts), float(js), rtol=1e-6)
        sim, frame = tpl.classify_bounce(sig, series, device="cpu")
        assert (sim, frame) == (float(ts), int(tf))
    assert tpl.classify_bounce(series[10:15], series, device="cpu")[1] == 40


def test_writers_bytes_identical(tmp_path):
    """jwr.write_hue_table_csv / append_cluster_centers_rows /
    write_optical_flow_csv ↔ twr: identical bytes."""
    rng = np.random.default_rng(7)
    hue = rng.integers(0, 180, (5, 350)).astype(np.uint8)
    cen = rng.integers(0, 256, (5 * 350, 4)).astype(np.int32)
    names = [f"{f}/{c + 1}.png" for f in range(2, 7) for c in range(350)]
    mags = np.concatenate([rng.gamma(1.0, 2.0, 6), [0.0, 1e-5, 1e16, 2.5e-7]]).astype(np.float32)
    for mod, tag in ((jwr, "j"), (twr, "t")):
        d = tmp_path / tag
        d.mkdir()
        mod.write_hue_table_csv(str(d / "OutCSV" / "v.csv"), hue)
        mod.append_cluster_centers_rows(str(d / "addnew.csv"), names, cen, hue.reshape(-1))
        mod.append_cluster_centers_rows(str(d / "cc.csv"), names[:9], cen[:9], hue.reshape(-1)[:9], header=True)
        mod.append_cluster_centers_rows(str(d / "cc.csv"), names[9:12], cen[9:12], hue.reshape(-1)[9:12], header=True)
        mod.write_optical_flow_csv(str(d / "v_opticalFlow.csv"), mags)
    for f in ("OutCSV/v.csv", "addnew.csv", "cc.csv", "v_opticalFlow.csv"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes(), f
