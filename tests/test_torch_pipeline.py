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
    """The overlay call runs: with --nocontour only (YOLO boxes on), the
    port's CLI writes the OutCSV and -f bytes the JAX CLI writes over the
    same yolo_labels.txt; without that file both raise FileNotFoundError.
    The stream is feature-only and still refuses overlays, as in JAX. Where
    --path is no file the cell tree at -d is clustered; asked for cuda where
    there is none, every path raises before writing anything."""
    from opticalflowclustering_tpu.cli import kmeangrids as jcli

    base = ["-d", "OutImgs/v", "-c", "1", "-f", "a.csv", "--path", DEMO]
    rows = np.zeros((2, 11))
    rows[:, 0], rows[0, 3:7], rows[1, 3:7] = (2, 3), (20, 30, 60, 40), (-3, 100, 50, 200)
    written = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        with pytest.raises(FileNotFoundError, match="yolo_labels.txt"):
            main(base + ["--nocontour", "--max-frames", "4"] + extra)
        np.savetxt(d / "yolo_labels.txt", rows)
        main(base + ["--nocontour", "--max-frames", "4"] + extra)
        written[side] = ((d / "OutCSV" / "v.csv").read_bytes(), (d / "a.csv").read_bytes())
        with pytest.raises(SystemExit, match="--stream is feature-only"):
            main(base + ["--noyolo", "--stream"] + extra)
    assert written["port"] == written["jax"] and written["port"][0].count(b"\n") == 4
    monkeypatch.chdir(tmp_path)
    # Where --path is no file, the cell tree at -d is clustered instead.
    tree = _write_cell_tree(tmp_path / "OutImgs" / "v")
    tcli.main(["-d", str(tree), "-c", "1", "-f", "a.csv", "--path", "missing.mp4", "--noyolo", "--nocontour",
               "--device", "cpu"])
    assert (tmp_path / "OutCSV" / "v.csv").read_bytes() == _jax_cell_tree_table(tmp_path, tree)
    (tmp_path / "OutCSV" / "v.csv").unlink()
    os.rmdir(tmp_path / "OutCSV")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base + ["--noyolo", "--nocontour", "--max-frames", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base + ["--max-frames", "3"])
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main(base + ["--noyolo", "--nocontour", "--stream"])
    with pytest.raises(RuntimeError, match="cuda"):  # the cell-tree path too
        tcli.main(["-d", str(tree), "-c", "1", "-f", "a.csv", "--path", "missing.mp4"])
    assert not (tmp_path / "OutCSV").exists()


def _write_cell_tree(root, frames=3, seed=0):
    """A seeded OutImgs/<video> tree: `frames` folders of 350 8×9 PNG cells
    with white top rows and left columns, as drawgrids --dump-cells writes."""
    import cv2

    rng = np.random.default_rng(seed)
    for f in range(frames):
        d = root / str(f + 2)
        d.mkdir(parents=True)
        for c in range(ROWS * COLS):
            cell = rng.integers(0, 256, (8, 9, 3), dtype=np.uint8)
            cell[0], cell[:, 0] = 255, 255
            cv2.imwrite(str(d / f"{c + 1}.png"), cell)
    return root


def _jax_cell_tree_table(tmp_path, tree):
    """OutCSV bytes of the JAX CLI's cell-tree path on `tree`, run in a
    directory of its own."""
    from opticalflowclustering_tpu.cli import kmeangrids as jcli

    d = tmp_path / "jax"
    d.mkdir(exist_ok=True)
    cwd = os.getcwd()
    os.chdir(d)
    try:
        jcli.main(["-d", str(tree), "-c", "1", "-f", "a.csv", "--path", "missing.mp4", "--noyolo", "--nocontour"])
    finally:
        os.chdir(cwd)
    return (d / "OutCSV" / f"{tree.name}.csv").read_bytes()


def test_kmeangrids_cli_refuses_an_lfs_pointer_stub(tmp_path, monkeypatch, capsys):
    """A Git-LFS pointer stub where the video should be: the port's
    is_lfs_pointer tells it from real media as the JAX package's does, and
    the CLI refuses to decode it: it says so and clusters the committed cell
    tree at -d instead, writing the OutCSV table the JAX CLI writes for that
    tree and one -f row per cell."""
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
    tree = _write_cell_tree(tmp_path / "OutImgs" / "601_3", frames=2, seed=1)
    capsys.readouterr()
    tcli.main(["-d", str(tree), "-c", "1", "-f", "a.csv", "--path", str(stub),
               "--noyolo", "--nocontour", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"{stub} is a Git-LFS pointer stub, not video data; clustering the committed cell "
                     f"tree at {tree} instead", "OutCSV/601_3.csv: 2 frames x 350 cells"]
    assert (tmp_path / "OutCSV" / "601_3.csv").read_bytes() == _jax_cell_tree_table(tmp_path, tree)
    rows = (tmp_path / "a.csv").read_text().splitlines()
    assert len(rows) == 2 * 350 and rows[0].startswith("2/1.png,[") and rows[-1].startswith("3/350.png,[")
