"""PyTorch port vs the JAX package: the bounce pipeline end to end and the
kmeangrids CLI (opticalflowclustering_tpu_torch.pipeline.bounce and .cli ↔
opticalflowclustering_tpu.pipeline.bounce and .cli).

End to end, each side computes its own flow. In static regions the flow is
~0 and its angle (so the hue) flips under float noise, so the tables are
held to the repo's own real-footage invariant (`_check_hues`: ≥97% of cells
exact, larger disagreements only in low-saturation cells) and the rendered
flow to ±2 per cell mean; the per-pair mean |flow| is held to rtol 1e-4
against JAX's flow computed un-jitted (on the synthetic clip, whose uniform
disc makes the 2×2 systems ill-conditioned, the jitted JAX pipeline's mean
|flow| differs from the port's by up to 1.2e-3 relative while the
un-jitted flow's agrees within 1e-4)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.compat import writers as jwr
from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.features.grid import grid_mean_bgr as j_grid_mean_bgr
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.flow.farneback import farneback_flow as j_flow
from opticalflowclustering_tpu.io.video import read_video_bgr
from opticalflowclustering_tpu.ops.colorspace import bgr2gray as j_gray
from opticalflowclustering_tpu.ops.polar import magnitude as j_magnitude
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu_torch.cli import kmeangrids as tcli
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl
from chip_smoke import cell_means, sat
from test_real_footage_e2e import _check_hues

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
ROWS, COLS = 14, 25


def _e2e(frames, mode):
    """jpl.process_frames ↔ tpl.process_frames (chunk 4, rendered flow kept)."""
    cfg = jpl.PipelineConfig(chunk=4, emit_flow_bgr=True, flow=JFlow(warp_mode=mode))
    want = {k: np.asarray(v) for k, v in jpl.process_frames(frames, cfg).items()}
    got = tpl.process_frames(frames, from_jax_config(cfg), device="cpu")
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
    assert got["hue_table"].shape == (frames.shape[0] - 1, ROWS * COLS)

    mean_diff = np.abs(cell_means(got["flow_bgr"]) - cell_means(want["flow_bgr"])).max()
    assert mean_diff <= 2.0, mean_diff
    _check_hues(got["hue_table"], want["hue_table"].astype(np.float32),
                sat(want["centroids"]), "OutCSV")
    _check_hues(got["rgb_hue_table"], want["rgb_hue_table"],
                sat(j_grid_mean_bgr(want["flow_bgr"], JGrid())), "rgb_values",
                min_exact=0.94)

    gray = np.asarray(j_gray(frames))
    flow = j_flow(gray[:-1], gray[1:], cfg.flow)
    want_mm = np.asarray(jnp.mean(j_magnitude(flow[..., 0], flow[..., 1]), axis=(-2, -1)))
    np.testing.assert_allclose(got["mean_magnitude"], want_mm, rtol=1e-4)
    return got


@pytest.mark.parametrize("mode", ["fast", "fast16"])
def test_process_frames_matches_jax_on_demo_clip(mode):
    """9 real frames of demo_out/601_3.avi (measured: every table cell
    equal to JAX's)."""
    _e2e(read_video_bgr(DEMO, 9), mode)


def test_chunk_stacking_matches_jax():
    frames = np.arange(7 * 2 * 2 * 3, dtype=np.uint8).reshape(7, 2, 2, 3)
    for chunk in (1, 4, 6, 16):
        got, n = tpl._stack_chunks(frames, chunk)
        want, m = jpl._stack_chunks(frames, chunk)
        assert n == m
        np.testing.assert_array_equal(got, want)


def test_kmeangrids_cli_on_demo_clip(tmp_path, monkeypatch):
    """The port's CLI on the first 17 frames of the demo clip (CPU): OutCSV
    equals the committed golden demo_out/OutCSV/601_3.csv up to
    `_check_hues` (measured on the whole clip: every cell equal), and its
    files are the JAX writers' bytes for the tables the port's
    process_frames returns."""
    monkeypatch.chdir(tmp_path)
    tcli.main([
        "-d", "OutImgs/601_3", "-c", "1", "-f", "addnew.csv", "--noyolo",
        "--nocontour", "--path", DEMO, "--device", "cpu", "--max-frames", "17",
    ])
    out = tpl.process_frames(
        read_video_bgr(DEMO, 17),
        tpl.PipelineConfig(emit_flow_bgr=False, flow=tpl.FarnebackParams(warp_mode="fast")),
        device="cpu",
    )
    jwr.write_hue_table_csv(str(tmp_path / "want.csv"), out["hue_table"])
    assert (tmp_path / "OutCSV" / "601_3.csv").read_bytes() == (tmp_path / "want.csv").read_bytes()
    rows = (tmp_path / "addnew.csv").read_text().splitlines()
    assert len(rows) == out["hue_table"].size and rows[0].startswith("2/1.png,[")
    golden = np.loadtxt(
        os.path.join(REPO, "demo_out", "OutCSV", "601_3.csv"), delimiter=",", skiprows=1
    )[:16]
    _check_hues(out["hue_table"], golden.astype(np.float32), sat(out["centroids"]), "golden")


def test_kmeangrids_cli_refuses_what_is_not_ported(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["-d", "OutImgs/v", "-c", "1", "-f", "a.csv", "--path", DEMO]
    with pytest.raises(SystemExit, match="overlays"):
        tcli.main(base + ["--nocontour"])
    with pytest.raises(SystemExit, match="overlays"):  # --stream is feature-only
        tcli.main(base + ["--noyolo", "--stream"])
    with pytest.raises(SystemExit, match="cell-tree"):
        tcli.main(["-d", "OutImgs/v", "-c", "1", "-f", "a.csv", "--path", "missing.mp4", "--noyolo", "--nocontour"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base + ["--noyolo", "--nocontour", "--max-frames", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base + ["--noyolo", "--nocontour", "--stream"])
    assert not (tmp_path / "OutCSV").exists()


def test_kmeangrids_cli_refuses_an_lfs_pointer_stub(tmp_path, monkeypatch):
    """A Git-LFS pointer stub where the video should be: the port's
    is_lfs_pointer tells it from real media as the JAX package's does, and the
    CLI exits with a message before it decodes or writes anything."""
    from opticalflowclustering_tpu.io.video import is_lfs_pointer as jax_is_lfs
    from opticalflowclustering_tpu_torch.io.video import is_lfs_pointer

    monkeypatch.chdir(tmp_path)
    stub = tmp_path / "601_3.mp4"
    stub.write_text(
        "version https://git-lfs.github.com/spec/v1\n"
        "oid sha256:0000000000000000000000000000000000000000000000000000000000000000\n"
        "size 123\n"
    )
    for path in (str(stub), DEMO, str(tmp_path / "missing.mp4")):
        assert is_lfs_pointer(path) == jax_is_lfs(path)
    assert is_lfs_pointer(str(stub)) and not is_lfs_pointer(DEMO)
    with pytest.raises(SystemExit, match="Git-LFS pointer stub"):
        tcli.main(["-d", "OutImgs/v", "-c", "1", "-f", "a.csv", "--path", str(stub),
                   "--noyolo", "--nocontour", "--device", "cpu"])
    assert not (tmp_path / "OutCSV").exists() and not (tmp_path / "a.csv").exists()
