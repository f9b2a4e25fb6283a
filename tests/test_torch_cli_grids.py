"""PyTorch port vs the JAX package: the drawgrids CLI in its four modes and
the kmeangrids cell-tree path (opticalflowclustering_tpu_torch.cli.drawgrids
/ .kmeangrids ↔ opticalflowclustering_tpu.cli.drawgrids / .kmeangrids).

Each side runs in its own working directory on its own copy of the first
frames of demo_out/601_3.avi (the CLIs write next to the video and under
the working directory), the port with --device cpu. Everything they write
that is integer is held bitwise: the `_rgb_values.csv` bytes, the dumped
cell PNGs (decoded and compared as arrays), the frames handed to the MJPG
writer (grid lines and cv2.putText labels, captured before the lossy
encode), `OutCSV/<video>.csv` and the `-f` rows."""

import os
import shutil

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cli import drawgrids as jdg
from opticalflowclustering_tpu.cli import kmeangrids as jkg
from opticalflowclustering_tpu.io import video as jvideo
from opticalflowclustering_tpu_torch.cli import drawgrids as tdg
from opticalflowclustering_tpu_torch.cli import kmeangrids as tkg
from opticalflowclustering_tpu_torch.features.grid import GridParams, extract_cells, whiten_grid_lines
from opticalflowclustering_tpu_torch.io import video as tvideo
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
FRAMES = 5
STUB = ("version https://git-lfs.github.com/spec/v1\n"
        "oid sha256:0000000000000000000000000000000000000000000000000000000000000000\nsize 123\n")


def _capture_writer(monkeypatch, module):
    """Replace module.write_video_mjpg with one that keeps what it is given."""
    seen = []
    monkeypatch.setattr(module, "write_video_mjpg", lambda path, frames, fps: seen.append((path, frames.copy(), fps)))
    return seen


def _tree(root):
    """{relative path: decoded array} of every PNG under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            out[os.path.relpath(p, root)] = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    return out


@pytest.mark.parametrize("mode", ["flow", "use-rgb", "optical", "tenbyten"])
def test_drawgrids_cli_writes_what_jax_writes(tmp_path, monkeypatch, capsys, mode):
    """jdg.main ↔ tdg.main (--device cpu) with --dump-cells --max-frames 5:
    `_rgb_values.csv` byte-equal, every cell PNG of OutImgs/601_3 equal as
    an array (4 frames × rows·cols cells), the frames given to the MJPG
    writer (flow render or source frames, grid lines, labels) array_equal,
    its path and fps equal, and the printed line equal. `optical` grids a
    pre-rendered flow video (written here from the port's render)."""
    extra = {"flow": [], "use-rgb": ["--use-rgb"], "tenbyten": ["--tenbyten"]}.get(mode, [])
    if mode == "optical":
        flow = tpl.process_frames(tvideo.read_video_bgr(DEMO, FRAMES), tpl.PipelineConfig(), "cpu")["flow_bgr"]
        optical = str(tmp_path / "flow.avi")
        tvideo.write_video_mjpg(optical, flow, 30.0)
        extra = ["--optical", optical]
    written, lines = {}, {}
    for side, main, module in (("jax", jdg.main, jvideo), ("port", tdg.main, tvideo)):
        d = tmp_path / side
        d.mkdir()
        shutil.copy(DEMO, d / "601_3.avi")
        monkeypatch.chdir(d)
        seen = _capture_writer(monkeypatch, module)
        argv = ["--path", str(d / "601_3.avi"), "--noyolo", "--nocontour", "--dump-cells",
                "--max-frames", str(FRAMES)] + extra
        main(argv + (["--device", "cpu"] if side == "port" else []))
        lines[side] = capsys.readouterr().out.replace(str(d), "<dir>")
        assert len(seen) == 1
        written[side] = seen[0]
    jd, td = tmp_path / "jax", tmp_path / "port"
    assert (td / "601_3.avi_rgb_values.csv").read_bytes() == (jd / "601_3.avi_rgb_values.csv").read_bytes()
    assert lines["port"] == lines["jax"]
    (jp, jf, jfps), (tp, tf, tfps) = written["jax"], written["port"]
    assert os.path.basename(tp) == os.path.basename(jp) == "601_3.avi_output.mp4" and tfps == jfps
    assert tf.dtype == np.uint8 and tf.shape == jf.shape == (FRAMES - 1, 232, 220, 3)
    np.testing.assert_array_equal(tf, jf)
    want, got = _tree(jd / "OutImgs"), _tree(td / "OutImgs")
    rows, cols = (10, 10) if mode == "tenbyten" else (14, 25)
    assert sorted(got) == sorted(want) and len(want) == (FRAMES - 1) * rows * cols
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_drawgrids_cli_refuses_overlays_and_cuda_without_cuda(tmp_path, monkeypatch):
    """The port's drawgrids without --noyolo --nocontour (as the JAX CLI is
    called by default) writes the `_rgb_values.csv` bytes the JAX CLI
    writes, the flags changing nothing on either side; asked for cuda where
    there is none, it raises before writing anything."""
    csv = {}
    for side, main, module, flags in (("jax", jdg.main, jvideo, []), ("port", tdg.main, tvideo, ["--device", "cpu"]),
                                      ("port-flags", tdg.main, tvideo, ["--noyolo", "--nocontour", "--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        path = shutil.copy(DEMO, d / "601_3.avi")
        monkeypatch.chdir(d)
        monkeypatch.setattr(module, "write_video_mjpg", lambda *a: None)
        main(["--path", str(path), "--max-frames", "4"] + flags)
        csv[side] = (d / "601_3.avi_rgb_values.csv").read_bytes()
    assert csv["port"] == csv["jax"] == csv["port-flags"] and csv["jax"].count(b"\n") == 4
    empty = tmp_path / "empty"
    empty.mkdir()
    monkeypatch.chdir(empty)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tdg.main(["--path", DEMO, "--max-frames", "2"])
    with pytest.raises(RuntimeError, match="cuda"):
        tdg.main(["--path", DEMO, "--noyolo", "--nocontour", "--max-frames", "2"])
    assert os.listdir(empty) == []


@pytest.fixture(scope="module")
def cell_tree(tmp_path_factory):
    """An OutImgs/601_3 cell tree written as drawgrids --dump-cells writes
    it: the port's flow render of the first frames of the demo clip →
    extract_cells → whiten_grid_lines(own_rectangle=True) → PNGs."""
    root = tmp_path_factory.mktemp("tree")
    flow = tpl.process_frames(tvideo.read_video_bgr(DEMO, FRAMES), tpl.PipelineConfig(), "cpu")["flow_bgr"]
    grid = GridParams()
    cells = whiten_grid_lines(extract_cells(torch.from_numpy(flow), grid), grid, own_rectangle=True).numpy()
    for f in range(cells.shape[0]):
        d = root / "OutImgs" / "601_3" / str(f + 2)
        d.mkdir(parents=True)
        for c in range(cells.shape[1]):
            cv2.imwrite(str(d / f"{c + 1}.png"), cells[f, c])
    return str(root / "OutImgs" / "601_3")


@pytest.mark.parametrize("case", ["missing", "stub", "stub-max-frames", "no-rb-swap", "overlay-flags"])
def test_kmeangrids_cell_tree_path_writes_what_jax_writes(tmp_path, monkeypatch, capsys, cell_tree, case):
    """jkg.main ↔ tkg.main (--device cpu) where --path is no file or a
    Git-LFS pointer stub: both cluster the -d cell tree, and
    OutCSV/601_3.csv and the -f rows are byte-equal, as is what they print
    (the stub's fallback line included). The overlay flags have no effect
    on this path, on either side."""
    path = {"missing": str(tmp_path / "missing.mp4")}.get(case, str(tmp_path / "601_3.mp4"))
    (tmp_path / "601_3.mp4").write_text(STUB)
    argv = ["-d", cell_tree, "-c", "1", "-f", "addnew.csv", "--path", path]
    argv += [] if case == "overlay-flags" else ["--noyolo", "--nocontour"]
    argv += {"stub-max-frames": ["--max-frames", "2"], "no-rb-swap": ["--no-rb-swap"]}.get(case, [])
    out = {}
    for side, main in (("jax", jkg.main), ("port", tkg.main)):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        main(argv + (["--device", "cpu"] if side == "port" else []))
        out[side] = (capsys.readouterr().out, (d / "OutCSV" / "601_3.csv").read_bytes(),
                     (d / "addnew.csv").read_bytes())
    assert out["port"] == out["jax"]
    text, table, rows = out["port"]
    n = 2 if case == "stub-max-frames" else FRAMES - 1
    assert ("Git-LFS pointer stub" in text) == (case != "missing")
    assert table.count(b"\n") == n + 1 and rows.count(b"\n") == n * 350
