"""The port's scan and searchengine CLIs (opticalflowclustering_tpu_torch.cli.
scan / searchengine ↔ opticalflowclustering_tpu.cli.scan / searchengine), in
the pattern of tests/test_cli_extra.py: with --device cpu they write the same
files and print the same lines as the JAX CLIs; asked for cuda where there
is none they raise."""

import contextlib
import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cli import scan as jscan
from opticalflowclustering_tpu.cli import searchengine as jsearch
from opticalflowclustering_tpu_torch.cli import scan as tscan
from opticalflowclustering_tpu_torch.cli import searchengine as tsearch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(41)


def _lines(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue().splitlines()


def test_scan_cli_equals_jax(tmp_path, monkeypatch):
    """test_cli_extra.py's document: the same printed line and byte-equal
    _warped.png and _binarized.png; `python -m` runs the port's CLI; an
    image with no quad prints the JAX CLI's line."""
    img = np.full((240, 200, 3), 30, np.uint8)
    quad = np.array([[40, 30], [160, 40], [150, 200], [30, 190]])
    cv2.fillPoly(img, [quad], (250, 250, 250))
    cv2.imwrite(str(tmp_path / "doc.png"), img)
    cv2.imwrite(str(tmp_path / "flat.png"), np.full((80, 60, 3), 30, np.uint8))
    monkeypatch.chdir(tmp_path)
    got = _lines(tscan.main, ["-i", "doc.png", "-o", "port", "--device", "cpu"])
    want = _lines(jscan.main, ["-i", "doc.png", "-o", "jax"])
    assert [ln.replace("port", "jax") for ln in got] == want and got[0].startswith("wrote port_warped.png")
    for suffix in ("_warped.png", "_binarized.png"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes(), suffix
    assert _lines(tscan.main, ["-i", "flat.png", "--device", "cpu"]) == _lines(jscan.main, ["-i", "flat.png"]) == [
        "no 4-point document contour found"]
    r = subprocess.run([sys.executable, "-m", "opticalflowclustering_tpu_torch.cli.scan", "-i", "doc.png",
                        "--device", "cpu"], cwd=tmp_path, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.splitlines() == [got[0].replace("port", "scanned")], r.stderr[-2000:]
    assert (tmp_path / "scanned_warped.png").read_bytes() == (tmp_path / "jax_warped.png").read_bytes()


def test_searchengine_cli_equals_jax(tmp_path, monkeypatch):
    """index over five images (one not an image) and search -k 3: the same
    printed lines, the same names in the index and features within rtol
    1e-6."""
    d = tmp_path / "photos"
    d.mkdir()
    for i in range(4):
        cv2.imwrite(str(d / f"p{i}.png"), RNG.integers(0, 256, (40, 60, 3), dtype=np.uint8))
    (d / "notes.txt").write_text("not an image")
    monkeypatch.chdir(tmp_path)
    got = _lines(tsearch.main, ["index", "-d", "photos", "-i", "port.npz", "--device", "cpu"])
    want = _lines(jsearch.main, ["index", "-d", "photos", "-i", "jax.npz"])
    assert [ln.replace("port", "jax") for ln in got] == want == ["indexed 4 images -> jax.npz"]
    a, b = np.load("port.npz"), np.load("jax.npz")
    np.testing.assert_array_equal(a["names"], b["names"])
    np.testing.assert_allclose(a["features"], b["features"], rtol=1e-6, atol=1e-9)
    got = _lines(tsearch.main, ["search", "-i", "port.npz", "-q", "photos/p1.png", "-k", "3", "--device", "cpu"])
    want = _lines(jsearch.main, ["search", "-i", "jax.npz", "-q", "photos/p1.png", "-k", "3"])
    assert got == want and len(got) == 3 and got[0].endswith("\tp1.png")


def test_extra_clis_refuse_cuda_where_there_is_none(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cv2.imwrite(str(tmp_path / "a.png"), np.zeros((20, 20, 3), np.uint8))
    with pytest.raises(RuntimeError, match="cuda"):
        tscan.main(["-i", str(tmp_path / "a.png")])
    with pytest.raises(RuntimeError, match="cuda"):
        tsearch.main(["index", "-d", str(tmp_path), "-i", str(tmp_path / "i.npz")])
