"""Fault-tolerant multi-video work queue with feature persistence (port of
`opticalflowclustering_tpu/pipeline/queue.py`).

The reference has no failure handling (its loops `break` on a failed
`cap.read()`, `KmeanGrids.py:185`) and nothing resumable. Here a host-side
per-video queue retries failed videos, checkpoints each video's feature
tables as `.npz` (the JAX package's keys, so its `load_features` reads these
files), and skips finished videos on resume. `process_video_queue_dp` fans
the queue out over a dp×sp mesh.

Videos are decoded through the `io.video` module, looked up at call time,
so a caller can stand another decoder in for cv2.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import traceback

import numpy as np
import torch

from opticalflowclustering_tpu_torch.io import video as io_video
from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames
from opticalflowclustering_tpu_torch.utils.logging import get_logger
from opticalflowclustering_tpu_torch.utils.profiling import span, spanned

log = get_logger("ofc_torch.queue")

_SAVED_KEYS = ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude")

#: Filled in by the last `process_video_queue_dp` call with
#: {"peak_buffered_videos", "batches", "evictions", "batch_failures"}.
#: "batches" counts successful mesh runs only (a failed one lands in
#: "batch_failures" and its videos go through the sequential queue), so
#: `batches >= 1 and batch_failures == 0` shows that the mesh path ran.
LAST_DP_STATS: dict[str, int] = {}


@dataclasses.dataclass
class VideoResult:
    video: str
    ok: bool
    path: str | None = None
    error: str | None = None
    attempts: int = 0


def _artifact_path(out_dir: str, video_path: str) -> str:
    stem = os.path.splitext(os.path.basename(video_path))[0]
    return os.path.join(out_dir, f"{stem}.features.npz")


def _save_tables(artifact: str, tables: dict[str, np.ndarray]) -> None:
    with span("ofc.save"):
        np.savez_compressed(artifact, **{k: np.asarray(tables[k]) for k in _SAVED_KEYS})


def process_video_queue(
    video_paths: list[str],
    out_dir: str,
    cfg: PipelineConfig = PipelineConfig(),
    max_retries: int = 2,
    resume: bool = True,
    max_frames: int | None = None,
    device: str | torch.device = "cuda",
) -> list[VideoResult]:
    """Run the pipeline over many videos on `device`, with retry and resume.

    Persists {hue_table, rgb_hue_table, centroids, mean_magnitude} per video
    as `<out_dir>/<stem>.features.npz`; a video is tried up to
    `max_retries + 1` times; on resume, videos whose artifact exists are
    skipped (attempts 0). Returns one VideoResult per input."""
    os.makedirs(out_dir, exist_ok=True)
    # The queue keeps the feature tables only, never the rendered flow.
    feature_cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
    results = []
    for path in video_paths:
        artifact = _artifact_path(out_dir, path)
        if resume and os.path.exists(artifact):
            log.info("skip %s (artifact exists)", path)
            results.append(VideoResult(path, True, artifact, attempts=0))
            continue
        last_err = None
        for attempt in range(1, max_retries + 2):
            try:
                frames = io_video.read_video_bgr(path, max_frames)
                out = process_frames(frames, feature_cfg, device)
                _save_tables(artifact, out)
                log.info("done %s (%d pairs, attempt %d)", path, out["hue_table"].shape[0], attempt)
                results.append(VideoResult(path, True, artifact, attempts=attempt))
                break
            except Exception as e:  # noqa: BLE001 — the queue must survive any video
                last_err = f"{type(e).__name__}: {e}"
                log.warning("attempt %d failed for %s: %s", attempt, path, last_err)
                log.debug("%s", traceback.format_exc())
        else:
            results.append(
                VideoResult(path, False, None, error=last_err, attempts=max_retries + 1)
            )
    return results


def load_features(artifact_path: str) -> dict[str, np.ndarray]:
    with np.load(artifact_path) as z:
        return {k: z[k] for k in z.files}


@spanned("ofc.process_video_queue_dp")
def process_video_queue_dp(
    video_paths: list[str],
    out_dir: str,
    mesh,
    cfg: PipelineConfig = PipelineConfig(),
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    resume: bool = True,
    max_frames: int | None = None,
    shard_hosts: bool = True,
) -> list[VideoResult]:
    """Mesh fan-out of the queue: videos ride the dp axis and each video's
    frames the sp axis, so a dp×sp mesh (`parallel.mesh.Mesh`) runs dp
    videos per batch through `parallel.temporal.sharded_hue_pipeline_videos`.

    In a process group (`shard_hosts=True`, the default) each process first
    takes its round-robin share of the list (`multihost.host_shard`) and then
    runs on its own dp rows of the mesh only (`multihost.local_submesh`), so
    nothing crosses processes while videos are processed. Each process
    returns VideoResults for its own share; artifacts land under `out_dir`
    on a shared filesystem, so resume works whichever process owned a video.

    Streaming with bounded host memory: a prefetch thread decodes ahead
    through a bounded queue while this thread buckets videos by shape and
    runs each dp-sized same-shape group as soon as it fills, so the decoder
    keeps decoding behind the card. At most `max_buffered` = 2·dp decoded
    videos wait in buckets: when odd shapes would exceed that, the oldest is
    evicted to an immediate single-video run (`process_frames` on the mesh's
    first device). End-of-stream leftovers run the same way, from the frames
    already in memory. `LAST_DP_STATS` records the observed peak.

    Artifacts carry the same keys as `process_video_queue`'s; the integer
    tables are equal to its tables and mean_magnitude agrees to rtol 1e-6
    (`parallel/temporal.py`). A failed batch retries its unsaved videos
    through the sequential queue."""
    from opticalflowclustering_tpu_torch.parallel.multihost import (
        host_shard,
        local_submesh,
        process_count,
    )
    from opticalflowclustering_tpu_torch.parallel.temporal import sharded_hue_pipeline_videos

    os.makedirs(out_dir, exist_ok=True)
    if shard_hosts and process_count() > 1:
        paths = host_shard(video_paths)
        mesh = local_submesh(mesh, dp_axis)
    else:
        paths = list(video_paths)
    dp = mesh.shape[dp_axis]
    sp = mesh.shape[sp_axis]
    single_device = mesh.devices.flat[0]
    max_buffered = 2 * dp
    feature_cfg = dataclasses.replace(cfg, emit_flow_bgr=False)

    results: list[VideoResult] = []
    todo = []
    for p in paths:
        artifact = _artifact_path(out_dir, p)
        if resume and os.path.exists(artifact):
            log.info("skip %s (artifact exists)", p)
            results.append(VideoResult(p, True, artifact, attempts=0))
        else:
            todo.append(p)

    # The prefetch-decode thread: a stream of (path, frames or exception),
    # bounded so decode runs at most two videos ahead of the batches.
    decoded: queue.Queue = queue.Queue(maxsize=2)
    stop = threading.Event()

    def decoder():
        for p in todo:
            if stop.is_set():
                return
            try:
                with span("ofc.decode"):
                    item = (p, io_video.read_video_bgr(p, max_frames))
            except Exception as e:  # noqa: BLE001 — reported as this video's result
                item = (p, e)
            decoded.put(item)
        decoded.put(None)

    decode_thread = threading.Thread(target=decoder, name="ofc-queue-decode", daemon=True)

    retry_paths: list[str] = []
    failed_decode: list[VideoResult] = []
    saved_ok: set[str] = set()

    def save(p: str, tables: dict[str, np.ndarray]) -> None:
        artifact = _artifact_path(out_dir, p)
        _save_tables(artifact, tables)
        results.append(VideoResult(p, True, artifact, attempts=1))
        saved_ok.add(p)

    def run_batch(group) -> None:
        names = [p for p, _ in group]
        with span("ofc.stack"):
            vids = np.stack([f for _, f in group])  # [dp, N, H, W, 3]
            n = vids.shape[1]
            n_pad = (-n) % sp
            if n_pad:  # repeat the last frame so sp divides N; the extra pairs are dropped
                vids = np.concatenate([vids, np.repeat(vids[:, -1:], n_pad, axis=1)], axis=1)
        tables = sharded_hue_pipeline_videos(
            vids, mesh, dp_axis, sp_axis, grid=cfg.grid, params=cfg.flow, rb_swap=cfg.rb_swap
        )
        with span("ofc.readback"):
            hue, rgb_hue, cen, mag = (t[:, : n - 1].numpy() for t in tables)
        for i, p in enumerate(names):
            save(p, {"hue_table": hue[i], "rgb_hue_table": rgb_hue[i],
                     "centroids": cen[i], "mean_magnitude": mag[i]})
        log.info("dp batch done: %s (%d pairs each)", names, n - 1)

    def run_single(p: str, frames: np.ndarray, why: str) -> None:
        """An evicted or leftover video: its frames are in memory already,
        so it runs the single-device pipeline directly (the same tables)."""
        try:
            save(p, process_frames(frames, feature_cfg, single_device))
        except Exception as e:  # noqa: BLE001 — retried through the sequential queue
            log.warning("%s single run failed for %s (%s); queueing retry", why, p, e)
            retry_paths.append(p)

    buckets: dict[tuple, list] = collections.defaultdict(list)
    order: collections.deque = collections.deque()  # FIFO for eviction
    buffered = 0
    stats = {"peak_buffered_videos": 0, "batches": 0, "evictions": 0, "batch_failures": 0}

    def dispatch(group) -> None:
        try:
            run_batch(group)
            stats["batches"] += 1
        except Exception as e:  # noqa: BLE001 — retried video by video
            stats["batch_failures"] += 1
            log.warning("dp batch failed (%s); retrying sequentially", e)
            # A batch can fail part-way through its saves: retry only the
            # videos whose artifact did not land (one VideoResult per input).
            retry_paths.extend(p for p, _ in group if p not in saved_ok)

    def evict_oldest() -> None:
        nonlocal buffered
        while order:
            shape, p0 = order.popleft()
            bucket = buckets.get(shape)
            idx = next((i for i, (p, _) in enumerate(bucket or ()) if p == p0), None)
            if idx is None:
                continue
            p, frames = bucket.pop(idx)
            if not bucket:
                del buckets[shape]
            buffered -= 1
            stats["evictions"] += 1
            run_single(p, frames, "evicted")
            return

    decode_thread.start()
    try:
        while True:
            with span("ofc.decode.wait"):
                item = decoded.get()
            if item is None:
                break
            p, frames = item
            if isinstance(frames, Exception):
                failed_decode.append(
                    VideoResult(p, False, None, error=f"{type(frames).__name__}: {frames}", attempts=1)
                )
                continue
            buckets[frames.shape].append((p, frames))
            order.append((frames.shape, p))
            buffered += 1
            stats["peak_buffered_videos"] = max(stats["peak_buffered_videos"], buffered)
            if len(buckets[frames.shape]) == dp:
                group = buckets.pop(frames.shape)
                buffered -= dp
                dispatch(group)  # the decoder keeps filling behind this batch
            elif buffered > max_buffered:
                evict_oldest()
    finally:
        stop.set()
        while decode_thread.is_alive():  # let a decoder blocked on put() finish
            try:
                decoded.get(timeout=0.05)
            except queue.Empty:
                pass
        decode_thread.join()

    # End-of-stream leftovers: decoded already, so single-video runs.
    for shape in list(buckets):
        for p, frames in buckets.pop(shape):
            buffered -= 1
            run_single(p, frames, "leftover")

    if retry_paths:
        results.extend(
            process_video_queue(
                retry_paths, out_dir, cfg, resume=resume, max_frames=max_frames,
                device=single_device,
            )
        )
    results.extend(failed_decode)
    LAST_DP_STATS.clear()
    LAST_DP_STATS.update(stats)
    return results
