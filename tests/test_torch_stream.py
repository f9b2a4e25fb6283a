"""PyTorch port vs the JAX package: the streaming decode path
(opticalflowclustering_tpu_torch.io.video.assemble_chunks / prefetch_chunks /
stream_video_chunks and pipeline.bounce.process_video_stream ↔
opticalflowclustering_tpu.io.video.assemble_chunks and
pipeline.bounce.process_video_stream), and `kmeangrids --stream`.

The stream's contract is that chunking changes nothing: its tables equal the
batch path's (`process_frames`) and the JAX stream's, integer tables bitwise
and mean_magnitude within rtol 1e-6 (measured: bitwise on the CPU)."""

import os
import threading

import cv2
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.io import video as jvideo
from opticalflowclustering_tpu.pipeline import bounce as jpl
from opticalflowclustering_tpu_torch.cli import kmeangrids as tcli
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.io import video as tvideo
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
INT_KEYS = ("hue_table", "rgb_hue_table", "centroids")


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 12-frame 70×100 MJPG clip: blurred seeded noise with a moving blob
    (the JAX stream test's clip), written by the JAX package's writer."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(12, 70, 100, 3), dtype=np.uint8)
    frames = np.stack([cv2.GaussianBlur(f, (0, 0), 2) for f in frames])
    for i in range(12):
        cv2.circle(frames[i], (10 + 5 * i, 30), 8, (30, 220, 200), -1)
    path = str(tmp_path_factory.mktemp("stream") / "clip.avi")
    jvideo.write_video_mjpg(path, frames, fps=30.0)
    return path


def _jcfg(mode, chunk):
    return jpl.PipelineConfig(
        grid=JGrid(rows=5, cols=5), flow=JFlow(warp_mode=mode, levels=2), chunk=chunk,
        emit_flow_bgr=False,
    )


def _assert_tables_equal(got, want, tag):
    assert set(got) == set(want), tag
    for k in INT_KEYS:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (tag, k)
    assert got["mean_magnitude"].dtype == np.float32
    np.testing.assert_allclose(got["mean_magnitude"], want["mean_magnitude"], rtol=1e-6, err_msg=tag)


@pytest.mark.parametrize("chunk", [4, 16])
def test_assemble_chunks_matches_jax(chunk):
    """jvideo.assemble_chunks: 11 frames (a tail that does not divide),
    overlap 1 and 2: batch for batch the same arrays and n_valid."""
    rng = np.random.default_rng(chunk)
    frames = list(rng.integers(0, 256, size=(11, 6, 5, 3), dtype=np.uint8))
    for overlap in (1, 2):
        got = list(tvideo.assemble_chunks(iter(frames), chunk, overlap))
        want = list(jvideo.assemble_chunks(iter(frames), chunk, overlap))
        assert len(got) == len(want) == -(-(11 - overlap) // chunk)
        for (gb, gn), (wb, wn) in zip(got, want):
            assert gn == wn and gb.dtype == wb.dtype and np.array_equal(gb, wb)


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("chunk", [4, 16])
def test_stream_matches_jax_stream_and_process_frames(clip, mode, chunk):
    """jpl.process_video_stream ↔ tpl.process_video_stream on the 12-frame
    clip (grid 5×5, 2 levels), and the port's stream ↔ its process_frames on
    the same decoded frames."""
    jcfg = _jcfg(mode, chunk)
    cfg = from_jax_config(jcfg)
    got = tpl.process_video_stream(clip, cfg, device="cpu")
    want_jax = {k: np.asarray(v) for k, v in jpl.process_video_stream(clip, jcfg).items()}
    want_batch = tpl.process_frames(tvideo.read_video_bgr(clip), cfg, device="cpu")
    assert got["hue_table"].shape == (11, 25) and got["hue_table"].dtype == np.uint8
    assert got["centroids"].dtype == np.int32 and got["rgb_hue_table"].dtype == np.float32
    _assert_tables_equal(got, want_batch, "vs process_frames")
    _assert_tables_equal(got, want_jax, "vs the JAX stream")


@pytest.mark.parametrize("chunk", [1, 3, 16])
@pytest.mark.parametrize("source", ["prefetch", "list"])
def test_stream_tables_and_process_frames_run_one_loop(clip, chunk, source):
    """`_stream_tables` over the prefetch thread's batches, or over a list
    of assembled batches (no thread), and process_frames over the same
    decoded frames: one chunk loop, the same tables (a zero-padded tail
    there, a repeated last frame here)."""
    frames = tvideo.read_video_bgr(clip)
    cfg = from_jax_config(_jcfg("fast", chunk))
    if source == "prefetch":
        chunks = tvideo.prefetch_chunks(iter(frames), chunk)
    else:
        chunks = list(tvideo.assemble_chunks(iter(frames), chunk, 1))
    tpl.reset_chunk_counts()
    got = tpl._stream_tables(chunks, cfg, torch.device("cpu"))
    assert tpl.CHUNK_COUNTS["chunks"] == -(-(frames.shape[0] - 1) // chunk)
    _assert_tables_equal(got, tpl.process_frames(frames, cfg, "cpu"), f"{source} chunk {chunk}")
    assert tpl._stream_tables(iter([]), cfg, torch.device("cpu")) is None


def test_stream_step_error_reaches_the_caller_and_stops_the_decode_thread(clip, monkeypatch):
    """A step that raises in the second chunk: process_video_stream raises
    it, and the decode thread is stopped and joined."""
    step, calls = tpl.chunk_step, []

    def chunk_step(*a, **k):
        if calls:
            raise RuntimeError("step 1 failed")
        calls.append(1)
        return step(*a, **k)

    monkeypatch.setattr(tpl, "chunk_step", chunk_step)
    threads = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="step 1 failed"):
        tpl.process_video_stream(clip, from_jax_config(_jcfg("fast", 4)), device="cpu")
    assert set(threading.enumerate()) == threads


def test_stream_needs_two_frames_and_respects_max_frames(clip, tmp_path):
    """A 1-frame clip raises ValueError (as jpl.process_video_stream does);
    max_frames cuts the stream as it cuts read_video_bgr."""
    one = str(tmp_path / "one.avi")
    jvideo.write_video_mjpg(one, np.zeros((1, 40, 40, 3), np.uint8), 30.0)
    cfg = from_jax_config(_jcfg("fast", 4))
    with pytest.raises(ValueError, match="2 frames"):
        tpl.process_video_stream(one, cfg, device="cpu")
    with pytest.raises(ValueError, match="2 frames"):
        jpl.process_video_stream(one, _jcfg("fast", 4))
    got = tpl.process_video_stream(clip, cfg, max_frames=6, device="cpu")
    assert got["hue_table"].shape == (5, 25)
    _assert_tables_equal(got, tpl.process_frames(tvideo.read_video_bgr(clip, 6), cfg, "cpu"), "max_frames")
    batches = list(tvideo.stream_video_chunks(clip, 4, max_frames=6))
    assert [n for _, n in batches] == [4, 1]
    assert np.array_equal(batches[0][0], tvideo.read_video_bgr(clip, 5))


def test_decode_error_reaches_the_consumer(clip):
    """An error of the source is raised on the consumer's side, after the
    batches before it; an unreadable file raises FileNotFoundError from the
    stream; a consumer that stops early stops the thread and closes the
    source."""
    cfg = from_jax_config(_jcfg("fast", 4))
    with pytest.raises(FileNotFoundError):
        tpl.process_video_stream(os.path.join(REPO, "demo_out", "no_such.avi"), cfg, device="cpu")

    def broken():
        for i in range(6):
            yield np.full((4, 4, 3), i, np.uint8)
        raise OSError("corrupt frame 6")

    seen = []
    with pytest.raises(OSError, match="corrupt frame 6"):
        for batch, n_valid in tvideo.prefetch_chunks(broken(), 2):
            seen.append(n_valid)
    assert seen == [2, 2]

    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield np.full((4, 4, 3), i % 256, np.uint8)
                i += 1
        finally:
            closed.append(True)

    stream = tvideo.prefetch_chunks(endless(), 2, prefetch=1)
    assert next(stream)[1] == 2
    stream.close()  # joins the thread
    assert closed == [True]


def test_kmeangrids_stream_reproduces_golden_csv(tmp_path, monkeypatch):
    """`kmeangrids --stream --device cpu` on the whole demo clip writes
    demo_out/OutCSV/601_3.csv byte for byte (the JAX CLI's golden output),
    and its addnew rows equal those of the CLI without --stream."""
    monkeypatch.chdir(tmp_path)
    base = ["-d", "OutImgs/601_3", "-c", "1", "--noyolo", "--nocontour", "--path", DEMO, "--device", "cpu"]
    tcli.main(base + ["-f", "stream.csv", "--stream"])
    with open(os.path.join(REPO, "demo_out", "OutCSV", "601_3.csv"), "rb") as f:
        assert (tmp_path / "OutCSV" / "601_3.csv").read_bytes() == f.read()
    tcli.main(base + ["-f", "batch.csv", "--max-frames", "9"])
    stream_rows = (tmp_path / "stream.csv").read_bytes().splitlines()
    batch_rows = (tmp_path / "batch.csv").read_bytes().splitlines()
    assert len(stream_rows) == 74 * 350 and stream_rows[: len(batch_rows)] == batch_rows
