"""PyTorch port vs the JAX package: the multi-video queue
(opticalflowclustering_tpu_torch.pipeline.queue.process_video_queue /
process_video_queue_dp / load_features and cli.processqueue ↔
opticalflowclustering_tpu.pipeline.queue and cli.processqueue).

Artifacts: the integer tables (hue, rgb_hue, centroids) equal, JAX's
`load_features` reads the port's `.npz` files, and mean_magnitude within
rtol 1e-5 of JAX's (each side computes its own flow; measured ≤ 8e-7) and
within rtol 1e-6 between the port's two queues (measured: bitwise)."""

import os
import time

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.cli import processqueue as jcli
from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.io.video import write_video_mjpg
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu.pipeline import queue as jq
from opticalflowclustering_tpu_torch.cli import processqueue as tcli
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.io import video as tvideo
from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
from opticalflowclustering_tpu_torch.pipeline import queue as tq

torch.set_num_threads(1)

JCFG = jpl.PipelineConfig(grid=JGrid(rows=4, cols=4), flow=JFlow(levels=1, warp_mode="fast"), chunk=4)
CFG = from_jax_config(JCFG)
INT_KEYS = ("hue_table", "rgb_hue_table", "centroids")


def _write_clips(d, n_clips, seed, shape=(6, 64, 64, 3), grow=0):
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_clips):
        p = str(d / f"clip{i}.avi")
        size = (shape[0], shape[1] + grow * i) + shape[2:]
        write_video_mjpg(p, rng.integers(0, 256, size=size, dtype=np.uint8), 30.0)
        paths.append(p)
    return paths


@pytest.fixture()
def clips(tmp_path):
    """Three same-shape clips: at dp=2, two batch and one is a leftover."""
    return _write_clips(tmp_path, 3, 0)


def _mesh():
    return make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)


def _artifact(d, p):
    return os.path.join(d, os.path.splitext(os.path.basename(p))[0] + ".features.npz")


def _assert_same(a, b, rtol, tag):
    assert sorted(a) == sorted(b) == sorted(INT_KEYS + ("mean_magnitude",)), tag
    for k in INT_KEYS:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (tag, k)
    np.testing.assert_allclose(a["mean_magnitude"], b["mean_magnitude"], rtol=rtol, err_msg=tag)


def test_queue_artifacts_match_jax_queue(clips, tmp_path):
    """jq.process_video_queue ↔ tq.process_video_queue --device cpu on three
    clips; jq.load_features reads the port's artifacts."""
    want = jq.process_video_queue(clips, str(tmp_path / "jax"), JCFG)
    got = tq.process_video_queue(clips, str(tmp_path / "torch"), CFG, device="cpu")
    assert [r.ok for r in got] == [r.ok for r in want] == [True] * 3
    assert [r.attempts for r in got] == [1, 1, 1]
    for r in got:
        assert r.path == _artifact(str(tmp_path / "torch"), r.video)
        port = jq.load_features(r.path)
        assert port["hue_table"].shape == (5, 16) and port["centroids"].shape == (5, 16, 4)
        _assert_same(port, jq.load_features(_artifact(str(tmp_path / "jax"), r.video)), 1e-5, r.video)
        _assert_same(tq.load_features(r.path), port, 0, r.video)


def test_queue_retries_resumes_and_survives_a_bad_video(clips, tmp_path, monkeypatch):
    """A bad video: ok=False with its error after max_retries + 1 attempts,
    the others finish; a decoder that fails once: attempts 2; resume skips
    finished videos (attempts 0)."""
    bad = str(tmp_path / "bad.avi")
    with open(bad, "wb") as f:
        f.write(b"not a video")
    out = str(tmp_path / "out")
    res = tq.process_video_queue(clips[:2] + [bad], out, CFG, max_retries=1, device="cpu")
    by = {r.video: r for r in res}
    assert not by[bad].ok and by[bad].attempts == 2 and by[bad].path is None
    assert "FileNotFoundError" in by[bad].error or "ValueError" in by[bad].error
    assert all(by[p].ok and by[p].attempts == 1 for p in clips[:2])

    real = tvideo.read_video_bgr
    failed = []

    def flaky(path, max_frames=None):  # the queue looks the decoder up at call time
        if not failed:
            failed.append(path)
            raise OSError("transient read error")
        return real(path, max_frames)

    monkeypatch.setattr(tvideo, "read_video_bgr", flaky)
    res = tq.process_video_queue(clips, out, CFG, device="cpu")
    assert [r.attempts for r in res] == [0, 0, 2] and failed == [clips[2]]
    assert all(r.ok for r in res)
    res = tq.process_video_queue(clips, out, CFG, resume=False, max_frames=3, device="cpu")
    assert [r.attempts for r in res] == [1, 1, 1]
    assert tq.load_features(res[0].path)["hue_table"].shape == (2, 16)


def test_dp_queue_matches_sequential_queue(clips, tmp_path):
    """tq.process_video_queue_dp on a 2×2 CPU mesh ↔ tq.process_video_queue,
    the leftover video included; the mesh path ran (LAST_DP_STATS)."""
    seq = tq.process_video_queue(clips, str(tmp_path / "seq"), CFG, device="cpu")
    dp = tq.process_video_queue_dp(clips, str(tmp_path / "dp"), _mesh(), CFG)
    assert all(r.ok for r in seq + dp) and len(dp) == 3
    assert tq.LAST_DP_STATS == {"peak_buffered_videos": 2, "batches": 1, "evictions": 0, "batch_failures": 0}
    for p in clips:
        _assert_same(tq.load_features(_artifact(str(tmp_path / "dp"), p)),
                     tq.load_features(_artifact(str(tmp_path / "seq"), p)), 1e-6, p)


def test_dp_queue_streams_and_bounds_what_it_buffers(tmp_path, monkeypatch):
    """Four same-shape clips at dp=2: the first batch's artifacts land while
    the last clip is still to be decoded (the decoder waits to see one), at
    most dp videos wait in buckets; seven clips of distinct shapes: the
    buffer stays within 2·dp (+1 transient) by eviction, and every artifact
    equals the sequential queue's."""
    paths = _write_clips(tmp_path, 4, 3)
    out = str(tmp_path / "out")
    real = tvideo.read_video_bgr
    seen = []

    def spying(path, max_frames=None):
        if path == paths[-1]:
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and not seen:
                if os.path.isdir(out) and any(f.endswith(".npz") for f in os.listdir(out)):
                    seen.append(True)
                time.sleep(0.02)
        return real(path, max_frames)

    monkeypatch.setattr(tvideo, "read_video_bgr", spying)
    res = tq.process_video_queue_dp(paths, out, _mesh(), CFG)
    monkeypatch.setattr(tvideo, "read_video_bgr", real)
    assert all(r.ok for r in res) and len(res) == 4 and seen == [True]
    assert tq.LAST_DP_STATS == {"peak_buffered_videos": 2, "batches": 2, "evictions": 0, "batch_failures": 0}

    (tmp_path / "odd").mkdir()
    odd = _write_clips(tmp_path / "odd", 7, 4, shape=(4, 48, 64, 3), grow=8)
    res = tq.process_video_queue_dp(odd, str(tmp_path / "dpod"), _mesh(), CFG)
    assert all(r.ok for r in res) and len(res) == 7
    stats = dict(tq.LAST_DP_STATS)
    assert stats["peak_buffered_videos"] <= 2 * 2 + 1 and stats["evictions"] >= 1 and stats["batches"] == 0
    tq.process_video_queue(odd, str(tmp_path / "seqod"), CFG, device="cpu")
    for p in odd:
        _assert_same(tq.load_features(_artifact(str(tmp_path / "dpod"), p)),
                     tq.load_features(_artifact(str(tmp_path / "seqod"), p)), 1e-6, p)


def test_dp_queue_survives_a_bad_video_and_resumes(clips, tmp_path):
    bad = str(tmp_path / "bad.avi")
    with open(bad, "wb") as f:
        f.write(b"not a video")
    out = str(tmp_path / "out")
    res = tq.process_video_queue_dp(clips + [bad], out, _mesh(), CFG)
    by = {r.video: r for r in res}
    assert not by[bad].ok and by[bad].attempts == 1 and by[bad].error
    assert all(by[p].ok for p in clips) and len(res) == 4
    res = tq.process_video_queue_dp(clips, out, _mesh(), CFG)
    assert [r.attempts for r in res] == [0, 0, 0]


def test_processqueue_cli_matches_jax_cli(clips, tmp_path):
    """jcli.main ↔ tcli.main, sequential and `--dp 2 --sp 2 --device cpu`:
    exit 0, an artifact per clip, and --addnew rows byte-equal to the JAX
    CLI's."""
    def run(mod, tag, *extra):
        addnew = str(tmp_path / f"{tag}.csv")
        rc = mod.main([*clips, "-o", str(tmp_path / tag), "--addnew", addnew,
                       "--warp-mode", "fast", *extra])
        assert rc == 0, tag
        with open(addnew, "rb") as f:
            return f.read()

    want = run(jcli, "jax")
    assert want.count(b"\n") == 3 * 5 * 350
    assert run(tcli, "seq", "--device", "cpu") == want
    assert run(tcli, "dp", "--dp", "2", "--sp", "2", "--device", "cpu") == want
    assert run(jcli, "jaxdp", "--dp", "2", "--sp", "2") == want


def test_processqueue_cli_needs_dp_sp_cuda_devices(clips, tmp_path, monkeypatch):
    """`--dp 2 --sp 2` on cuda with one CUDA device exits with the JAX CLI's
    message; without CUDA the CLI raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tcli.main([*clips, "-o", str(tmp_path / "x")])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--dp 2 --sp 2 needs 4 devices; 1 available"):
        tcli.main([*clips, "-o", str(tmp_path / "x"), "--dp", "2", "--sp", "2"])
    assert not os.path.exists(tmp_path / "x")
