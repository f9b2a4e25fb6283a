"""PyTorch port vs the JAX package: the video-file CLIs and the rgb_values
writer (opticalflowclustering_tpu_torch.cli.computeopticalflow / findcosine
and compat.writers.write_rgb_values_csv ↔ the JAX modules of the same name).

computeopticalflow: the telemetry CSV within 1e-5 per magnitude of the JAX
CLI's on a 5-frame clip, and within 1e-4 (the tolerance the JAX package's
CLI test holds its magnitudes to against cv2) of the committed
demo_out/601_3.avi_opticalFlow.csv. findcosine: the same printed lines,
the similarity within 1e-6 and the frame equal."""

import os

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

from opticalflowclustering_tpu.cli import computeopticalflow as jcof
from opticalflowclustering_tpu.cli import findcosine as jfind
from opticalflowclustering_tpu.compat import writers as jwr
from opticalflowclustering_tpu.io.video import write_video_mjpg
from opticalflowclustering_tpu_torch.cli import computeopticalflow as tcof
from opticalflowclustering_tpu_torch.cli import findcosine as tfind
from opticalflowclustering_tpu_torch.compat import writers as twr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")


@pytest.mark.parametrize("with_nan", [False, True])
def test_write_rgb_values_csv_bytes_equal_jax(tmp_path, with_nan):
    """jwr.write_rgb_values_csv (pandas) ↔ twr.write_rgb_values_csv (csv):
    the same bytes for seeded hue means, integral and not, and NaN."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 180, (6, 350)).astype(np.float32)
    table[2] += rng.random(350).astype(np.float32)
    if with_nan:
        table[1, 5] = np.nan
    jwr.write_rgb_values_csv(str(tmp_path / "j.csv"), table)
    twr.write_rgb_values_csv(str(tmp_path / "t.csv"), table)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


def _run_cof(mod, clip, capsys, *extra):
    mod.main(["-i", clip, "--max-frames", "5", *extra])
    return capsys.readouterr().out.splitlines()


def _blob_clip(n, h, w):
    """Blurred seeded noise with a moving filled circle (the JAX stream
    test's clip): textured everywhere, so every 2×2 system is well posed."""
    rng = np.random.default_rng(0)
    frames = np.stack([cv2.GaussianBlur(f, (0, 0), 2) for f in rng.integers(0, 256, (n, h, w, 3), np.uint8)])
    for i in range(n):
        cv2.circle(frames[i], (20 + 6 * i, h // 2), 12, (30, 220, 200), -1)
    return frames


def test_computeopticalflow_matches_jax_cli(tmp_path, capsys):
    """jcof.main ↔ tcof.main --device cpu on a 5-frame 144×256 clip: the
    three outputs, the printed lines, and the telemetry within 1e-5."""
    frames = _blob_clip(5, 144, 256)
    clips = {}
    for side in ("jax", "torch"):
        (tmp_path / side).mkdir()
        clips[side] = str(tmp_path / side / "clip.avi")
        write_video_mjpg(clips[side], frames, 30.0)
    want_lines = _run_cof(jcof, clips["jax"], capsys)
    got_lines = _run_cof(tcof, clips["torch"], capsys, "--device", "cpu")
    for suffix in ("onlyOpticalflow.mp4", "_opticalFlow.csv", "_squares.png"):
        assert os.path.getsize(clips["torch"] + suffix) > 0, suffix
    want = pd.read_csv(clips["jax"] + "_opticalFlow.csv", index_col=0)
    got = pd.read_csv(clips["torch"] + "_opticalFlow.csv", index_col=0)
    assert list(got.columns) == ["Frame", "Average Magnitude"] and len(got) == 4
    np.testing.assert_array_equal(got["Frame"], want["Frame"])
    np.testing.assert_allclose(got["Average Magnitude"], want["Average Magnitude"], rtol=0, atol=1e-5)
    assert float(got["Average Magnitude"].max()) > 0.1
    assert len(got_lines) == len(want_lines) == 8
    for g, w in zip(got_lines, want_lines):
        if g.startswith("Average Magnitude"):
            assert abs(float(g.split()[-1]) - float(w.split()[-1])) <= 1e-5
        else:
            assert g == w
    # The rendered flow video decodes to the frames the port rendered.
    from opticalflowclustering_tpu_torch.io.video import read_video_bgr

    assert read_video_bgr(clips["torch"] + "onlyOpticalflow.mp4").shape == (4, 144, 256, 3)


def test_computeopticalflow_on_demo_clip_matches_committed_csv(tmp_path, capsys):
    """The port's CLI on the first 17 frames of demo_out/601_3.avi: its 16
    magnitudes within 1e-4 of the committed demo_out/601_3.avi_opticalFlow.csv."""
    clip = str(tmp_path / "601_3.avi")
    with open(DEMO, "rb") as src, open(clip, "wb") as dst:
        dst.write(src.read())
    tcof.main(["-i", clip, "--max-frames", "17", "--device", "cpu"])
    assert "Number of VideoFrames processed 16 / 17" in capsys.readouterr().out
    got = pd.read_csv(clip + "_opticalFlow.csv", index_col=0)
    want = pd.read_csv(DEMO + "_opticalFlow.csv", index_col=0)[:16]
    np.testing.assert_allclose(got["Average Magnitude"], want["Average Magnitude"], rtol=0, atol=1e-4)


def _write_series(path, values):
    with open(path, "w") as f:
        f.writelines(f"{i},{v}\n" for i, v in enumerate(values))


@pytest.mark.parametrize("case", ["planted", "random", "integer"])
def test_findcosine_matches_jax_cli(tmp_path, capsys, case):
    """jfind.main ↔ tfind.main --device cpu on seeded hue CSVs: the same four
    lines, the similarity within 1e-6 and the same frame."""
    rng = np.random.default_rng({"planted": 0, "random": 1, "integer": 2}[case])
    series = rng.integers(0, 180, 60).astype(np.float64) + (0 if case == "integer" else rng.random(60))
    sig = series[31:36].copy() if case == "planted" else rng.random(5) * 180
    values = {"sig.csv": sig, "ser.csv": series}
    for name, v in values.items():
        _write_series(str(tmp_path / name), v.astype(np.int64) if case == "integer" else v)
    files = [str(tmp_path / "sig.csv"), str(tmp_path / "ser.csv")]
    jfind.main(files)
    want = capsys.readouterr().out.splitlines()
    tfind.main(files + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    assert got[0] == want[0] == "Vector sizes are:  5 60"
    assert abs(float(got[1].split(":")[1]) - float(want[1].split(":")[1])) <= 1e-6
    assert got[2] == want[2] and got[3] == want[3]
    if case == "planted":
        assert got[3] == "Max frame: 31"


def test_findcosine_reads_column_one_as_pandas_does(tmp_path, monkeypatch):
    """tfind.read_column ↔ pd.read_csv(header=None).iloc[:, 1]: integers,
    floats, an empty field (NaN) and extra columns."""
    p = tmp_path / "s.csv"
    p.write_text("0,12,a\n1,13.5,b\n2,,c\n3,-4e-3,d\n")
    want = pd.read_csv(p, header=None).iloc[:, 1].values.astype(np.float64)
    got = tfind.read_column(str(p))
    np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tfind.main([str(p), str(p)])
