"""The chunk loop of `pipeline/bounce.py` (`_chunk_loop`) on the card, where
it is a software pipeline: pinned staging slots filled by a staging thread
(or, for small chunks, by the caller), uploads on a copy stream, each
chunk's tables read one chunk late.

Its CPU form is tested in `test_torch_pipeline.py` and `test_torch_stream.py`.
These tests need a CUDA card and skip without one; run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_chunk_loop.py

The card's tables are held bit for bit to the same steps run one chunk at a
time on the card, each chunk uploaded from the clip and read back before
the next (the loop before it was pipelined): the copies must change no bit.
The card's flow differs from the CPU's by its arithmetic, not by its copies
(`chip_smoke.py` holds that gap), so the CPU is not the oracle here."""

import json

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
from opticalflowclustering_tpu_torch.io import video as io_video
from opticalflowclustering_tpu_torch.pipeline import bounce
from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

H, W = 64, 96


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run this file with -m cuda on one)")
    return torch.device("cuda")


@pytest.fixture(params=["caller", "thread"])
def staging(request, monkeypatch):
    """Where chunks after the first are staged: on the caller's thread, as
    this file's small frames are, or with the size rule lowered to 0 bytes
    on the staging thread, as a 720p clip's are."""
    if request.param == "thread":
        monkeypatch.setattr(bounce, "_STAGE_ON_THREAD_BYTES", 0)
    return request.param


def _overlays(tmp_path, n_frames):
    """YOLO boxes on every other frame, some cut by the frame's edge."""
    rows = [[f, 0, 0, (7 * f) % W - 5, (5 * f) % H - 3, 20, 12, 0, 0, 0, 0] for f in range(2, n_frames + 1, 2)]
    path = tmp_path / "yolo_labels.txt"
    np.savetxt(path, np.array(rows, dtype=np.float64))
    return bounce.OverlaySpec(yolo_file=str(path))


def _one_chunk_at_a_time(clip, cfg, dev, overlays):
    """The steps of `process_frames` run one chunk at a time: a pageable
    upload straight from the clip, the step, and a blocking read back."""
    n_pairs = clip.shape[0] - 1
    yolo = bounce.load_yolo_boxes(overlays.yolo_file) if overlays is not None else None
    parts = []
    for start in range(0, n_pairs, cfg.chunk):
        n_valid = min(cfg.chunk, n_pairs - start)
        frames = torch.from_numpy(bounce._chunk_frames(clip, start, cfg.chunk)).to(dev)
        if overlays is None:
            out = bounce.chunk_step(frames, cfg, dev)
        else:
            out = bounce._overlay_step(frames, cfg, dev, overlays, yolo, start, n_valid)
        parts.append({k: v[:n_valid].cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.mark.cuda
@pytest.mark.parametrize("overlay", [False, True], ids=["tables", "overlays"])
@pytest.mark.parametrize("chunk, n_frames", [(2, 8), (16, 20), (16, 17)])
def test_card_loop_is_bitwise_the_chunk_at_a_time_steps(cuda, tmp_path, staging, chunk, n_frames, overlay):
    """Chunk 2 over 7 pairs and chunk 16 over 19 (padded tails) and over 16
    (one chunk), with the render returned, with and without overlays, staged
    on either thread: every key, flow_bgr and mean_magnitude included, bit
    for bit; every chunk uploaded from a pinned slot."""
    clip = synth_frames(n_frames, H, W)
    cfg = bounce.PipelineConfig(flow=FarnebackParams(warp_mode="fast", levels=2), chunk=chunk)
    spec = _overlays(tmp_path, n_frames) if overlay else None
    before = clip.copy()
    bounce.reset_chunk_counts()
    got = bounce.process_frames(clip, cfg, cuda, overlays=spec)
    counts = dict(bounce.CHUNK_COUNTS)
    want = _one_chunk_at_a_time(clip, cfg, cuda, spec)
    assert sorted(got) == sorted(want) and "flow_bgr" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape == (n_frames - 1,) + v.shape[1:], k
        assert np.array_equal(got[k], v), f"{k}: {int((got[k] != v).sum())} entries differ"
    n_chunks = -(-(n_frames - 1) // chunk)
    assert counts["chunks"] == counts["pinned"] == n_chunks
    assert np.array_equal(clip, before)


@pytest.mark.cuda
def test_card_stream_loop_is_bitwise_process_frames(cuda):
    """`_stream_tables` over the prefetch thread's batches (zero-padded
    tail) on the card: the tables of process_frames, bit for bit."""
    clip = synth_frames(12, H, W)
    cfg = bounce.PipelineConfig(flow=FarnebackParams(warp_mode="fast", levels=2), chunk=4, emit_flow_bgr=False)
    want = bounce.process_frames(clip, cfg, cuda)
    chunks = io_video.prefetch_chunks(iter(clip), cfg.chunk)
    try:
        got = bounce._stream_tables(chunks, cfg, cuda)
    finally:
        chunks.close()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def _trace(tmp_path, fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


@pytest.mark.cuda
@pytest.mark.parametrize("emit_flow_bgr", [False, True], ids=["tables", "render"])
def test_card_loop_copies_only_pinned_memory_and_uploads_beside_the_compute_stream(cuda, tmp_path, staging,
                                                                                     emit_flow_bgr):
    """Under torch.profiler, a warm process_frames at chunk 4 over 11 pairs,
    staged on either thread, makes no copy from or to pageable memory; its
    uploads (one a chunk) run
    on a stream on which none of the flow's kernels runs; it launches the
    kernels of the chunk-at-a-time steps, no more, all on one stream; and it
    allocates no device memory."""
    clip = synth_frames(12, H, W)
    cfg = bounce.PipelineConfig(flow=FarnebackParams(warp_mode="fast", levels=2), chunk=4,
                                emit_flow_bgr=emit_flow_bgr)
    bounce.process_frames(clip, cfg, cuda)  # warm: the kernels' build, the tables on the card
    _one_chunk_at_a_time(clip, cfg, cuda, None)
    events = _trace(tmp_path, lambda: bounce.process_frames(clip, cfg, cuda))
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    pageable = sorted({e["name"] for e in copies if "Pageable" in e["name"]})
    assert not pageable, pageable
    uploads = [e for e in copies if "HtoD" in e["name"]]
    assert len(uploads) == 3, sorted(e["name"] for e in uploads)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flow_streams = {e["args"]["stream"] for e in kernels if "warp_m" in e["name"] or "box_solve" in e["name"]}
    assert flow_streams and not flow_streams & {e["args"]["stream"] for e in uploads}
    assert {e["args"]["stream"] for e in kernels} == flow_streams
    steps = [e for e in _trace(tmp_path, lambda: _one_chunk_at_a_time(clip, cfg, cuda, None))
             if e.get("cat") == "kernel"]
    assert len(kernels) == len(steps)
    assert not [e for e in events if e.get("cat") == "cuda_runtime" and e["name"] == "cudaMalloc"]


@pytest.mark.cuda
def test_card_loop_allocates_no_pinned_memory_once_warm(cuda):
    """Two calls in a row: the second allocates no pinned host memory (the
    caching host allocator hands back the first call's slots)."""
    stats = getattr(torch.cuda.memory, "host_memory_stats", None)
    if stats is None:
        pytest.skip("this torch has no torch.cuda.memory.host_memory_stats")
    clip = synth_frames(12, H, W)
    cfg = bounce.PipelineConfig(flow=FarnebackParams(warp_mode="fast", levels=2), chunk=4)
    bounce.process_frames(clip, cfg, cuda)
    torch.cuda.synchronize()
    before = stats()["num_host_alloc"]
    bounce.process_frames(clip, cfg, cuda)
    torch.cuda.synchronize()
    assert stats()["num_host_alloc"] == before
