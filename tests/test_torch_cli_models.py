"""PyTorch port vs the JAX package: the clustering and model CLIs and the
stream that feeds the real-time one (opticalflowclustering_tpu_torch.cli.
colorkmeans / classify / detect / trainbounce / realtime and io.video.
VideoStream ↔ the JAX modules of the same path), run in-process on the CPU
(`--device cpu`).

colorkmeans: the CSV and the printed rows byte-equal to the JAX CLI's at k=1
on seeded cells, and at k=3 on images of well-separated flat colours (there
the result does not depend on the ++ draws). classify and detect: the same
printed lines (the timing line by its format) and, for detect -o, the same
annotated image. trainbounce: the same dataset line, the JAX CLI's npz keys,
and the saved npz loads into the JAX BounceClassifier with logits within
1e-5 of the port model's. realtime: the demo clip with --max-frames."""

import os
import re

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cli import classify as jclassify
from opticalflowclustering_tpu.cli import colorkmeans as jckm
from opticalflowclustering_tpu.cli import detect as jdetect
from opticalflowclustering_tpu.cli import trainbounce as jtrain
from opticalflowclustering_tpu.models import bounce_classifier as jbc
from opticalflowclustering_tpu_torch.cli import classify as tclassify
from opticalflowclustering_tpu_torch.cli import colorkmeans as tckm
from opticalflowclustering_tpu_torch.cli import detect as tdetect
from opticalflowclustering_tpu_torch.cli import realtime as trealtime
from opticalflowclustering_tpu_torch.cli import trainbounce as ttrain
from opticalflowclustering_tpu_torch.io.video import VideoStream, read_video_bgr

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
CPU = ["--device", "cpu"]


def _run(main, argv, capsys):
    main(argv)
    return capsys.readouterr().out.splitlines()


def _cells_dir(tmp_path, name, cells):
    d = tmp_path / name
    d.mkdir()
    for i, c in enumerate(cells):
        cv2.imwrite(str(d / f"{i + 1}.png"), c)
    return str(d)


def _flat_band_cells(n=6):
    """Cells of three flat colours in bands of unequal widths (the widest
    band differs from cell to cell), every channel ≥ 30 so the RGBA
    preprocess keeps it."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(n):
        cols = rng.integers(40, 250, (3, 3))
        widths = np.roll([24, 16, 10], i)
        out.append(np.concatenate([np.broadcast_to(c, (50, w, 3)) for c, w in zip(cols, widths)], 1))
    return [np.ascontiguousarray(c, np.uint8) for c in out]


@pytest.mark.parametrize("k", [1, 3])
def test_colorkmeans_dir_csv_byte_equal_jax(tmp_path, capsys, k):
    """jckm.main ↔ tckm.main in -d mode: the CSV bytes and the printed rows
    equal. k=1 on seeded noise cells (dark pixels included, so the alpha
    and the <30 threshold matter); k=3 on flat three-colour cells."""
    if k == 1:
        cells = list(np.random.default_rng(0).integers(0, 256, (7, 50, 50, 3), dtype=np.uint8))
    else:
        cells = _flat_band_cells()
    d = _cells_dir(tmp_path, "cells", cells)
    j_csv, t_csv = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    want = _run(jckm.main, ["-d", d, "-c", str(k), "-f", j_csv], capsys)
    got = _run(tckm.main, ["-d", d, "-c", str(k), "-f", t_csv] + CPU, capsys)
    assert got == want and len(got) == len(cells)
    with open(j_csv, "rb") as a, open(t_csv, "rb") as b:
        assert b.read() == a.read()


def test_colorkmeans_single_image_appends_like_jax(tmp_path, capsys):
    """-i mode twice into one CSV (header once, basename rows): the same
    bytes as the JAX CLI's."""
    img = str(tmp_path / "frame7.png")
    cv2.imwrite(img, np.random.default_rng(2).integers(0, 256, (40, 30, 3), dtype=np.uint8))
    for main, csv, extra in ((jckm.main, "j.csv", []), (tckm.main, "t.csv", CPU)):
        for _ in range(2):
            _run(main, ["-i", img, "-c", "1", "-f", str(tmp_path / csv)] + extra, capsys)
    assert (tmp_path / "t.csv").read_bytes() == (tmp_path / "j.csv").read_bytes()


@pytest.mark.parametrize("cli", ["colorkmeans", "classify", "detect", "realtime", "trainbounce"])
def test_clis_default_to_the_card_and_refuse_a_missing_one(tmp_path, monkeypatch, cli):
    """Each new CLI's default device is cuda, and asking for it where there is
    none raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img = str(tmp_path / "cell.png")
    cv2.imwrite(img, np.zeros((50, 50, 3), np.uint8))
    csvs = _hue_csvs(tmp_path)
    argv = {
        "colorkmeans": (tckm.main, ["-d", str(tmp_path), "-c", "1", "-f", str(tmp_path / "x.csv")]),
        "classify": (tclassify.main, ["-i", img]),
        "detect": (tdetect.main, ["-i", img]),
        "realtime": (trealtime.main, ["-s", DEMO, "--max-frames", "1"]),
        "trainbounce": (ttrain.main, ["--bounce", csvs["bounce.csv"], "--nobounce", csvs["nobounce.csv"],
                                      "--out", str(tmp_path / "p.npz")]),
    }
    main, args = argv[cli]
    with pytest.raises(RuntimeError, match="is_available"):
        main(args)


_TIMING = re.compile(r"^\[INFO\] classification took \d+\.\d{5} seconds$")


@pytest.mark.parametrize("shape", [(50, 50), (64, 80)])
def test_classify_prints_the_jax_lines(tmp_path, capsys, shape):
    """jclassify.main ↔ tclassify.main on a seeded cell (and on a larger
    image, resized to 50×50 first): the timing line in the demo's format,
    the ranked label lines equal."""
    img = str(tmp_path / "cell.png")
    cv2.imwrite(img, np.random.default_rng(3).integers(0, 256, shape + (3,), dtype=np.uint8))
    want = _run(jclassify.main, ["-i", img], capsys)
    got = _run(tclassify.main, ["-i", img] + CPU, capsys)
    assert _TIMING.match(got[0]) and _TIMING.match(want[0])
    assert got[1:] == want[1:] and len(got) == 3


@pytest.fixture(scope="module")
def flow_frame_png(tmp_path_factory):
    """A flow frame rendered from demo_out/601_3.avi by the port's pipeline,
    as a PNG."""
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames

    frames = read_video_bgr(DEMO, 6)
    flow = process_frames(frames[[0, 5]], PipelineConfig(chunk=1), device="cpu")["flow_bgr"][0]
    path = str(tmp_path_factory.mktemp("detect") / "flow.png")
    cv2.imwrite(path, flow)
    return path


@pytest.mark.parametrize("conf", ["0.9", "0.5"])
def test_detect_prints_the_jax_lines_and_draws_the_same_image(tmp_path, capsys, flow_frame_png, conf):
    """jdetect.main ↔ tdetect.main with -o on a rendered flow frame: the same
    '[INFO] label: conf%' lines and a byte-equal annotated PNG."""
    jo, to = str(tmp_path / "j.png"), str(tmp_path / "t.png")
    want = _run(jdetect.main, ["-i", flow_frame_png, "-c", conf, "-o", jo], capsys)
    got = _run(tdetect.main, ["-i", flow_frame_png, "-c", conf, "-o", to] + CPU, capsys)
    assert got == want
    np.testing.assert_array_equal(cv2.imread(to), cv2.imread(jo))
    if conf == "0.5":
        assert got and all(line.startswith("[INFO] bounce-clip flow: ") for line in got)


def _hue_csvs(tmp_path):
    rng = np.random.default_rng(4)
    paths = {}
    for name, n, lo, hi in (("bounce.csv", 15, 100, 140), ("nobounce.csv", 60, 0, 60)):
        p = tmp_path / name
        p.write_text("".join(f"{i}.png,{int(h)}\n" for i, h in enumerate(rng.integers(lo, hi, n))))
        paths[name] = str(p)
    return paths


def test_trainbounce_prints_the_jax_lines_and_saves_jax_keys(tmp_path, capsys):
    """jtrain.main ↔ ttrain.main on seeded hue CSVs: the same dataset line,
    the loss/accuracy line in the same format (each side from its own
    initialisation, both fitting: loss < 0.2), the same saved line, the
    same npz keys; and the JAX BounceClassifier applied to the port's npz
    gives the port model's logits within 1e-5."""
    csvs = _hue_csvs(tmp_path)
    common = ["--bounce", csvs["bounce.csv"], "--nobounce", csvs["nobounce.csv"], "--steps", "300"]
    want = _run(jtrain.main, common + ["--out", str(tmp_path / "j.npz")], capsys)
    model, loss = ttrain.main(common + ["--out", str(tmp_path / "t.npz")] + CPU)
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0] == "dataset: 59 windows (7 positive)"
    fmt = re.compile(r"^final loss (\d+\.\d{4}), train accuracy (\d\.\d{3})$")
    for line in (got[1], want[1]):
        m = fmt.match(line)
        assert m and float(m.group(1)) < 0.2 and float(m.group(2)) == 1.0, line
    assert got[2] == f"saved params to {tmp_path / 't.npz'}"
    with np.load(tmp_path / "j.npz") as j, np.load(tmp_path / "t.npz") as t:
        assert sorted(t.files) == sorted(j.files)
        tree = {"params": {}}
        for k in t.files:
            layer, leaf = re.findall(r"\['([^']*)'\]", k)[1:]
            tree["params"].setdefault(layer, {})[leaf] = jnp.asarray(t[k])
    x, _ = ttrain.build_dataset([csvs["bounce.csv"]], [csvs["nobounce.csv"]], 9)
    jx, _ = jtrain.build_dataset([csvs["bounce.csv"]], [csvs["nobounce.csv"]], 9)
    np.testing.assert_array_equal(x, jx)
    with torch.no_grad():
        mine = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jbc.BounceClassifier().apply(tree, jnp.asarray(x))), mine, atol=1e-5)


def test_realtime_on_the_demo_clip(tmp_path, capsys):
    """trealtime.main -s demo_out/601_3.avi --max-frames 5 -o out.avi: five
    frames scored, the demo's two FPS lines, and an MJPG of five annotated
    232×220 frames."""
    out = str(tmp_path / "rt.avi")
    n = trealtime.main(["-s", DEMO, "--max-frames", "5", "-o", out] + CPU)
    lines = capsys.readouterr().out.splitlines()
    assert n == 5
    assert re.match(r"^\[INFO\] elapsed time: \d+\.\d{2}$", lines[0]), lines
    assert re.match(r"^\[INFO\] approx\. FPS: \d+\.\d{2}$", lines[1]), lines
    assert read_video_bgr(out).shape == (5, 232, 220, 3)


def test_video_stream_reads_the_demo_clip_and_stops():
    """io.video.VideoStream unpaced over the demo clip: read() returns one of
    the clip's frames, running() turns false at the end of the file, and
    stop() joins the reader thread; a missing source raises."""
    frames = read_video_bgr(DEMO)
    vs = VideoStream(DEMO, paced=False).start()
    first = vs.read()
    assert first is not None and first.shape == frames.shape[1:]
    assert any(np.array_equal(first, f) for f in frames)
    vs._thread.join(30)
    assert not vs.running() and not vs._thread.is_alive()
    np.testing.assert_array_equal(vs.read(), frames[-1])
    vs.stop()
    paced = VideoStream(DEMO).start()
    assert paced.read() is not None and paced.running()
    paced.stop()
    assert not paced._thread.is_alive()
    with pytest.raises(FileNotFoundError):
        VideoStream(os.path.join(REPO, "demo_out", "no_such.avi"))
