"""The end-to-end bounce-feature pipeline (port of `opticalflowclustering_tpu/pipeline/bounce.py`).

  frames [N,H,W,3]u8 ──► gray ──► Farneback flow (N-1 pairs, batched)
    ──► HSV render (per-frame min-max) ──► grid cells + white-line overlay
    ──► RGBA preprocess ──► exact k=1 dominant hue      → OutCSV table
    ──► per-cell mean hue                               → rgb_values table
    ──► per-frame mean |flow|                           → telemetry CSV

Frame pairs are independent, so a video goes through in chunks of
`cfg.chunk` pairs: each chunk is copied to the device once, straight from
the caller's frames, runs `chunk_step` there, and only its tables (and the
rendered flow, when asked for) come back to the host.
`process_video_stream` also overlaps the host with the card: a thread
decodes the next chunk while the card computes the current one, and chunk
k's tables are copied back only after chunk k+1 has been enqueued; with
`native=True` an MJPEG AVI is decoded by the port's threaded C++ decoder
(`io.fastio`) instead of cv2. With `overlays` (YOLO boxes, contour masks),
`process_frames` draws them onto each rendered frame on the device, between
the render and the grid stage.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Iterable

import numpy as np
import torch

from opticalflowclustering_tpu_torch.cluster.matcher import match_signature
from opticalflowclustering_tpu_torch.features.dominant_color import (
    dominant_hue_k1,
    dominant_hue_k1_frames,
    preprocess_cells_rgba,
)
from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
from opticalflowclustering_tpu_torch.io import fastio
from opticalflowclustering_tpu_torch.io import video as io_video
from opticalflowclustering_tpu_torch.io.overlays import (
    apply_contour_mask,
    draw_rect_outline,
    load_contour_polys,
    load_yolo_boxes,
    yolo_rects_for_frame,
)
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.ops.polar import magnitude
from opticalflowclustering_tpu_torch.runtime import resolve_device
from opticalflowclustering_tpu_torch.utils.profiling import span, spanned


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    grid: GridParams = GridParams()
    flow: FarnebackParams = FarnebackParams()
    # Reproduce the R/B-swapped disk round trip that generated the golden
    # OutCSV tables.
    rb_swap: bool = True
    # Frame pairs per chunk (device memory / throughput trade-off).
    chunk: int = 16
    # Return the rendered flow video (~2.7 MB per 720p frame) as well as
    # the feature tables (~3 KB per frame).
    emit_flow_bgr: bool = True


@dataclasses.dataclass(frozen=True)
class OverlaySpec:
    """YOLO-box / contour overlays (`KmeanGrids.py:201-211`): the label table
    `yolo_file`, and `contour_dir`/<video_name>/<video_name>_<frame>.txt
    polygons, drawn onto each rendered flow frame before grid pooling. The
    documented runs disable both (--noyolo --nocontour)."""

    yolo_file: str | None = None
    contour_dir: str | None = None
    video_name: str = ""


def _render(frames: torch.Tensor, cfg: PipelineConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """[C+1, H, W, 3] uint8 BGR frames on the device → (mean |flow| [C],
    flow render [C, H, W, 3] uint8) of their C pairs."""
    with span("ofc.render"):
        gray = bgr2gray(frames)
    flow = farneback_flow(gray[:-1], gray[1:], cfg.flow)
    with span("ofc.render"):
        return magnitude(flow[..., 0], flow[..., 1]).mean(dim=(-2, -1)), render_flow_hsv_bgr(flow)


@torch.inference_mode()
def chunk_step(
    frames_chunk, cfg: PipelineConfig, device: str | torch.device = "cuda"
) -> dict[str, torch.Tensor]:
    """One chunk of C+1 BGR frames [C+1, H, W, 3] uint8 → features of its C
    pairs, computed on `device`; returns tensors on that device."""
    dev = resolve_device(device)
    with span("ofc.upload"):
        frames = torch.as_tensor(frames_chunk).to(dev)
    mean_mag, flow_bgr = _render(frames, cfg)
    with span("ofc.grid"):
        centroids, hue = dominant_hue_k1_frames(flow_bgr, cfg.grid, rb_swap=cfg.rb_swap)
        rgb_hue = grid_mean_hue(flow_bgr, cfg.grid)
    out = {
        "hue_table": hue,
        "rgb_hue_table": rgb_hue,
        # Per-cell RGBA centroids: the addnew.csv rows (`KmeanGrids.py:320-339`).
        "centroids": centroids,
        "mean_magnitude": mean_mag,
    }
    if cfg.emit_flow_bgr:
        out["flow_bgr"] = flow_bgr
    return out


def _chunk_frames(frames_bgr: np.ndarray, start: int, chunk: int) -> np.ndarray:
    """Frames start .. start+chunk of [N,H,W,3] as one chunk [chunk+1, H, W, 3]
    (it shares its first frame with the previous chunk's last): a view of a
    C-contiguous clip where the clip holds them all, so nothing is copied;
    the tail pads by repeating the final frame."""
    c = frames_bgr[start : start + chunk + 1]
    if c.shape[0] < chunk + 1:
        c = np.concatenate([c, np.repeat(c[-1:], chunk + 1 - c.shape[0], axis=0)])
    return np.ascontiguousarray(c)


def _stack_chunks(frames_bgr: np.ndarray, chunk: int) -> tuple[np.ndarray, int]:
    """[N,H,W,3] → the stack of its overlapping chunks [K, chunk+1, H, W, 3]
    (`_chunk_frames`), and the number of pairs."""
    n_pairs = frames_bgr.shape[0] - 1
    return np.stack([_chunk_frames(frames_bgr, s, chunk) for s in range(0, n_pairs, chunk)]), n_pairs


@torch.inference_mode()
def grid_cluster_stage(
    flow_bgr, grid: GridParams, rb_swap: bool, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Grid pooling and the dominant hue of pre-rendered flow frames (or any
    [N, H, W, 3] uint8 BGR frames), on `device`: (centroids [N, cells, 4]
    int32, hue_table [N, cells] uint8, rgb_hue_table [N, cells] float32)."""
    frames = torch.as_tensor(flow_bgr).to(resolve_device(device))
    with span("ofc.grid"):
        centroids, hue = dominant_hue_k1_frames(frames, grid, rb_swap=rb_swap)
        return centroids, hue, grid_mean_hue(frames, grid)


@spanned("ofc.process_frames")
def process_frames(
    frames_bgr: np.ndarray,
    cfg: PipelineConfig = PipelineConfig(),
    device: str | torch.device = "cuda",
    overlays: OverlaySpec | None = None,
) -> dict[str, np.ndarray]:
    """Full pipeline over decoded [N,H,W,3] uint8 BGR frames on `device`.

    Returns per-pair numpy arrays (N-1 rows): hue_table uint8,
    rgb_hue_table float32, centroids int32, mean_magnitude float32, and
    flow_bgr uint8 when cfg.emit_flow_bgr or `overlays` is given. With
    `overlays`, the YOLO boxes and contour masks of frame `start + 2 + i`
    (the reference counts the first decoded frame as 1 and pairs from frame
    2, `KmeanGrids.py:169,189`) are drawn onto pair i's rendered frame on
    the device, before the grid stage, as `KmeanGrids.py:201-231` orders
    them; the padded tail pairs of the last chunk get none."""
    frames_bgr = np.asarray(frames_bgr)
    if frames_bgr.shape[0] < 2:
        raise ValueError("need at least 2 frames")
    dev = resolve_device(device)
    n_pairs = frames_bgr.shape[0] - 1
    yolo = load_yolo_boxes(overlays.yolo_file) if overlays is not None and overlays.yolo_file else None
    outs = []
    for start in range(0, n_pairs, cfg.chunk):
        with span("ofc.stack"):
            chunk = torch.from_numpy(_chunk_frames(frames_bgr, start, cfg.chunk))
        if overlays is None:
            out = chunk_step(chunk, cfg, dev)
        else:
            out = _overlay_step(chunk, cfg, dev, overlays, yolo, start, min(cfg.chunk, n_pairs - start))
        with span("ofc.readback"):
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
    with span("ofc.readback"):
        return {k: np.concatenate([o[k] for o in outs])[:n_pairs] for k in outs[0]}


@torch.inference_mode()
def _overlay_step(
    frames: torch.Tensor, cfg: PipelineConfig, dev: torch.device, spec: OverlaySpec,
    yolo: np.ndarray | None, start: int, n_real: int,
) -> dict[str, torch.Tensor]:
    """chunk_step with the overlays drawn onto the first `n_real` rendered
    frames in place on the device, then the grid stage over those frames."""
    with span("ofc.upload"):
        frames = frames.to(dev)
    mean_mag, flow_bgr = _render(frames, cfg)
    flow_bgr = flow_bgr[:n_real]
    with span("ofc.overlay"):
        for i in range(n_real):
            frame_num = start + 2 + i
            if yolo is not None:
                for x, y, w, h in yolo_rects_for_frame(yolo, frame_num):
                    draw_rect_outline(flow_bgr[i], x, y, w, h)
            if spec.contour_dir:
                apply_contour_mask(flow_bgr[i], load_contour_polys(spec.contour_dir, spec.video_name, frame_num))
    centroids, hue, rgb_hue = grid_cluster_stage(flow_bgr, cfg.grid, cfg.rb_swap, dev)
    return {"hue_table": hue, "rgb_hue_table": rgb_hue, "centroids": centroids,
            "mean_magnitude": mean_mag[:n_real], "flow_bgr": flow_bgr}


def process_video_file(
    path: str,
    cfg: PipelineConfig = PipelineConfig(),
    max_frames: int | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """process_frames over a video decoded on the host by cv2
    (`io.video.read_video_bgr`)."""
    return process_frames(io_video.read_video_bgr(path, max_frames), cfg, device)


@spanned("ofc.process_video_stream")
def process_video_stream(
    path: str,
    cfg: PipelineConfig = PipelineConfig(),
    max_frames: int | None = None,
    native: bool = False,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Decode-inclusive pipeline over a video file on disk: a background
    thread decodes the next chunk while the card computes the current one
    (`io.video.stream_video_chunks`), unlike the reference's loop, which
    decodes inside its hot loop (`KmeanGrids.py:156,180-185`).

    native=True decodes an MJPEG AVI with the threaded C++ decoder, whose
    done flags release each frame as soon as it is decoded
    (`io.fastio.stream_mjpeg_avi`); its JPEG rounding differs from cv2's by a
    few codes, so golden-parity paths keep the default. The gate is the JAX
    package's: the 12-byte RIFF sniff (an mp4 never touches the decoder), then
    the full container and codec probe (an XVID AVI passes the sniff but not
    the probe); a file that fails either streams through cv2. An MJPEG AVI
    streams natively or raises.

    Feature-only whatever `cfg.emit_flow_bgr` says: the same keys and dtypes
    as `process_frames` without the rendered flow (hue_table uint8,
    rgb_hue_table float32, centroids int32, mean_magnitude float32), and the
    same values, since chunks share their overlap frame and every stage
    after the flow is per pair. Fewer than 2 frames raise ValueError."""
    dev = resolve_device(device)
    probe = fastio.probe_mjpeg_avi(path) if native and fastio.is_mjpeg_avi(path) else None
    if probe is not None:
        chunks = fastio.stream_mjpeg_avi(path, cfg.chunk, overlap=1, max_frames=max_frames, probe=probe)
    else:
        chunks = io_video.stream_video_chunks(path, cfg.chunk, overlap=1, max_frames=max_frames)
    try:
        tables = _stream_tables(chunks, cfg, dev)
    finally:
        chunks.close()
    if tables is None:
        raise ValueError(f"need at least 2 frames in {path}")
    return tables


@torch.inference_mode()
def _stream_tables(
    chunks: Iterable[tuple[np.ndarray, int]], cfg: PipelineConfig, dev: torch.device
) -> dict[str, np.ndarray] | None:
    """The device loop of `process_video_stream`, run on the caller's thread
    over ([C+1, H, W, 3] uint8, n_valid) batches of one fixed shape (from
    `io.video.prefetch_chunks` or `io.fastio.stream_mjpeg_avi`); None when
    there is no batch.

    On a CUDA device the host and the card overlap twice over. Each batch is
    staged in one of two pinned host buffers and copied up with
    `non_blocking`; its tables are copied down with `non_blocking` into one
    of two pinned table buffers; and chunk k's tables are read only after
    chunk k+1 has been enqueued. An event per buffer guards each reuse: the
    host waits for a buffer's last upload before it refills it, and for a
    chunk's downloads before it reads them. On the CPU the loop runs the same
    steps synchronously."""
    cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
    cuda = dev.type == "cuda"
    staged = [None, None]  # pinned copies of the last two batches
    uploaded = [None, None]  # event: the slot's upload has finished
    fetched = [None, None]  # (pinned tables, event: their download has finished)
    parts: list[dict[str, np.ndarray]] = []
    pending = None  # (slot, tables, n_valid) of the chunk not yet read

    def read(slot, tables, n_valid):
        with span("ofc.readback"):
            if cuda:
                fetched[slot][1].synchronize()
            parts.append({k: v[:n_valid].numpy().copy() for k, v in tables.items()})

    for k, (batch, n_valid) in enumerate(chunks):
        slot = k % 2
        with span("ofc.stack"):
            host = torch.from_numpy(batch)
            if cuda:
                if staged[slot] is None:
                    staged[slot] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
                else:
                    uploaded[slot].synchronize()
                staged[slot].copy_(host)
                host = staged[slot]
        with span("ofc.upload"):
            frames = host.to(dev, non_blocking=True)
            if cuda:
                uploaded[slot] = torch.cuda.Event()
                uploaded[slot].record(torch.cuda.current_stream(dev))
        out = chunk_step(frames, cfg, dev)
        if cuda:
            with span("ofc.readback"):
                if fetched[slot] is None:
                    fetched[slot] = (
                        {n: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for n, v in out.items()},
                        torch.cuda.Event(),
                    )
                tables, done = fetched[slot]
                for n, v in out.items():
                    tables[n].copy_(v, non_blocking=True)
                done.record(torch.cuda.current_stream(dev))
            out = tables
        if pending is not None:
            read(*pending)
        pending = (slot, out, n_valid)
    if pending is None:
        return None
    read(*pending)
    with span("ofc.readback"):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@torch.inference_mode()
def dominant_hue_series(
    frames_bgr, rb_swap: bool = True, device: str | torch.device = "cuda"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-frame dominant hue per frame (each frame is one "cell"):
    [N,H,W,3] u8 → (centroids [N,4] int32, hues [N] uint8) on `device`."""
    frames = torch.as_tensor(frames_bgr).to(resolve_device(device))
    return dominant_hue_k1(preprocess_cells_rgba(frames, rb_swap=rb_swap))


@torch.inference_mode()
def classify_bounce(
    signature_hue, series_hue, device: str | torch.device = "cuda"
) -> tuple[float, int]:
    """Sliding-window bounce match (`findCosineDifferentVectors.py:52-66`):
    (max cosine similarity, frame index), the last tie wins."""
    dev = resolve_device(device)
    sim, frame = match_signature(
        torch.as_tensor(signature_hue).to(dev, torch.float32),
        torch.as_tensor(series_hue).to(dev, torch.float32),
    )
    return float(sim), int(frame)
