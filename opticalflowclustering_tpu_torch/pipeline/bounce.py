"""The end-to-end bounce-feature pipeline (port of `opticalflowclustering_tpu/pipeline/bounce.py`).

  frames [N,H,W,3]u8 ──► gray ──► Farneback flow (N-1 pairs, batched)
    ──► HSV render (per-frame min-max) ──► grid cells + white-line overlay
    ──► RGBA preprocess ──► exact k=1 dominant hue      → OutCSV table
    ──► per-cell mean hue                               → rgb_values table
    ──► per-frame mean |flow|                           → telemetry CSV

Frame pairs are independent, so a video goes through in chunks of
`cfg.chunk` pairs, and one chunk loop (`_chunk_loop`) drives them all:
`process_frames` over the chunks of a clip in memory, `process_video_stream`
over the batches a decode thread assembles from a file (with `native=True`
an MJPEG AVI is decoded by the port's threaded C++ decoder, `io.fastio`,
instead of cv2). Only each chunk's tables (and the rendered flow, when
asked for) come back to the host. On a CUDA device the loop is a software
pipeline: chunk k+1 is copied into a pinned host slot (by a staging thread,
for all but small chunks) and a copy stream uploads it while the card
computes chunk k, and chunk k's tables come down on another stream and are
read only after chunk k+1 has been enqueued. On the CPU it runs the same
steps one after another. With
`overlays` (YOLO boxes, contour masks), `process_frames` draws them onto each
rendered frame on the device, between the render and the grid stage.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
from collections.abc import Callable, Iterable, Iterator

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
    them; the padded tail pairs of the last chunk get none. The clip is
    read, never written."""
    frames_bgr = np.asarray(frames_bgr)
    if frames_bgr.shape[0] < 2:
        raise ValueError("need at least 2 frames")
    dev = resolve_device(device)
    n_pairs = frames_bgr.shape[0] - 1
    if overlays is None:
        def step(frames, k, n_valid):
            return chunk_step(frames, cfg, dev)
    else:
        yolo = load_yolo_boxes(overlays.yolo_file) if overlays.yolo_file else None

        def step(frames, k, n_valid):
            return _overlay_step(frames, cfg, dev, overlays, yolo, k * cfg.chunk, n_valid)

    chunks = ((_chunk_frames(frames_bgr, start, cfg.chunk), min(cfg.chunk, n_pairs - start))
              for start in range(0, n_pairs, cfg.chunk))
    return _chunk_loop(chunks, step, dev)


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


def _stream_tables(
    chunks: Iterable[tuple[np.ndarray, int]], cfg: PipelineConfig, dev: torch.device
) -> dict[str, np.ndarray] | None:
    """The device loop of `process_video_stream`: `_chunk_loop` over
    ([C+1, H, W, 3] uint8, n_valid) batches of one fixed shape (from
    `io.video.prefetch_chunks` or `io.fastio.stream_mjpeg_avi`), tables
    only; None when there is no batch."""
    cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
    return _chunk_loop(chunks, lambda frames, k, n_valid: chunk_step(frames, cfg, dev), dev)


# Chunks through `_chunk_loop` since the last `reset_chunk_counts`: every
# chunk; those uploaded from a pinned slot; and those whose slot was not
# staged yet when the driving thread came to it (stalls).
CHUNK_COUNTS = dict.fromkeys(("chunks", "pinned", "stalls"), 0)


def reset_chunk_counts() -> None:
    """Set every chunk count to 0."""
    for k in CHUNK_COUNTS:
        CHUNK_COUNTS[k] = 0


Step = Callable[[torch.Tensor, int, int], dict[str, torch.Tensor]]


@torch.inference_mode()
def _chunk_loop(
    chunks: Iterable[tuple[np.ndarray, int]], step: Step, dev: torch.device
) -> dict[str, np.ndarray] | None:
    """The one device loop: `step(frames, k, n_valid)` on chunk k of
    `chunks`, ([C+1, H, W, 3] uint8, n_valid) pairs of one shape, and the
    first n_valid rows of each of its outputs, concatenated over the chunks
    on the host; None when there is no chunk.

    On a CUDA device the loop is a software pipeline. `_staged` copies chunk
    k+1 into one of two pinned host slots (on a staging thread, for all but
    small chunks) while the card computes chunk k; a copy stream uploads it
    into one of two device slots; the compute stream waits for that upload,
    and the copy stream waits for the chunk that last read a device slot
    before it overwrites it. Each chunk's outputs go down on a third stream
    into pinned buffers, and chunk k's are read only after chunk k+1 has been
    enqueued. On the CPU the same steps run one after another on the
    caller's thread."""
    cuda = dev.type == "cuda"
    parts: list[dict[str, np.ndarray]] = []
    if cuda:
        comp = torch.cuda.current_stream(dev)
        up, down = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        released: queue.Queue = queue.Queue()
        slots: list[torch.Tensor | None] = [None, None]  # device frame slots
        uploaded: list[torch.cuda.Event | None] = [None, None]  # event: the slot's upload has finished
        computed: list[torch.cuda.Event | None] = [None, None]  # event: the chunk that read the slot is done
        staged = _staged(chunks, released)
    else:
        staged = _unstaged(chunks)

    def upload(slot, host):
        if not cuda:
            return host
        with span("ofc.upload"):
            if slots[slot] is None:
                slots[:] = [torch.empty(host.shape, dtype=host.dtype, device=dev) for _ in slots]
                # The slots may reuse memory that work queued earlier on the
                # compute stream still reads; the caching allocator holds them
                # back from other tensors until the copy stream is done too.
                up.wait_stream(comp)
                for t in slots:
                    t.record_stream(up)
            elif computed[slot] is not None:
                up.wait_event(computed[slot])
            with torch.cuda.stream(up):
                slots[slot].copy_(host, non_blocking=True)
            # The staging thread waits for this event before it refills the
            # pinned slot: a blocking event lets it sleep there instead of
            # spinning in the driver beside the thread that launches.
            uploaded[slot] = torch.cuda.Event(blocking=True)
            uploaded[slot].record(up)
            released.put((slot, uploaded[slot]))
            CHUNK_COUNTS["pinned"] += 1
        return slots[slot]

    def download(slot, out):
        """(host tables, their copies' event, `out`): `out` is kept until
        the tables are read, so that no other tensor reuses its memory while
        the copies read it."""
        if not cuda:
            return out, None, None
        with span("ofc.readback"):
            # A view with gaps (the hue table) is made whole here, on the
            # compute stream, as `.cpu()` did: each copy down is one memcpy.
            out = {n: v.contiguous() for n, v in out.items()}
            computed[slot] = torch.cuda.Event()
            computed[slot].record(comp)
            down.wait_event(computed[slot])
            tables = {n: torch.empty(v.shape, dtype=v.dtype, pin_memory=True) for n, v in out.items()}
            with torch.cuda.stream(down):
                for n, v in out.items():
                    tables[n].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(down)
        return tables, done, out

    def read(tables, done, out, n_valid):
        with span("ofc.readback"):
            if done is not None:
                done.synchronize()
            # Views: each chunk's tables are fresh tensors, copied once, into
            # the result, by the concatenation below.
            parts.append({k: v[:n_valid].numpy() for k, v in tables.items()})

    with contextlib.closing(staged):
        nxt = next(staged, None)
        if nxt is None:
            return None
        frames = upload(*nxt[:2])
        pending = None
        k = 0
        while nxt is not None:
            slot, _, n_valid = nxt
            if cuda:
                comp.wait_event(uploaded[slot])
            out = step(frames, k, n_valid)
            CHUNK_COUNTS["chunks"] += 1
            fetched = download(slot, out)
            del out  # held by `fetched` on the card, until its tables are read
            nxt = next(staged, None)
            if nxt is not None:
                frames = upload(*nxt[:2])
            if pending is not None:
                read(*pending)
            pending = (*fetched, n_valid)
            k += 1
        read(*pending)
    with span("ofc.readback"):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _unstaged(chunks: Iterable[tuple[np.ndarray, int]]) -> Iterator[tuple[None, torch.Tensor, int]]:
    """`_staged` on the CPU: (None, the chunk as a tensor, n_valid), taken
    from `chunks` on the caller's thread as the loop comes to it."""
    for batch, n_valid in chunks:
        with span("ofc.stack"):
            host = torch.from_numpy(batch)
        yield None, host, n_valid


_END = object()

# A chunk of fewer bytes is staged on the caller's thread: its copy takes a
# fraction of a millisecond there, while a staging thread running beside the
# launching thread slowed the host-bound 232x220 crop (2.6 MB a chunk) by
# 12-25% (PERF.md, PR 22). A 720p chunk (47 MB) takes milliseconds to copy,
# which the thread hides behind the card's work.
_STAGE_ON_THREAD_BYTES = 16 << 20


def _staged(
    chunks: Iterable[tuple[np.ndarray, int]], released: queue.Queue
) -> Iterator[tuple[int, torch.Tensor, int]]:
    """Yield (slot, pinned host tensor, n_valid) for each chunk of `chunks`,
    copied into two pinned slots in turn. The caller puts (slot, event) on
    `released` once it has enqueued the slot's upload; the slot is refilled
    only after that event has completed. The first chunk is copied on the
    caller's thread, since nothing runs on the card yet to overlap it. The
    rest are copied by a staging thread, which runs ahead of the caller by
    one chunk, or on the caller's thread where a chunk is smaller than
    `_STAGE_ON_THREAD_BYTES`.

    As in `io.video.prefetch_chunks`: the thread touches only host memory,
    an exception of `chunks` is raised on the caller's side, and closing this
    generator stops the thread at its next slot and joins it. The caller's
    wait for a slot (or its own copy) is its `ofc.stack` span; the thread's
    wait and copy are an `ofc.stage` span. Pinned slots come from torch's
    caching host allocator, so a warm process allocates none."""
    it = iter(chunks)
    first = next(it, None)
    if first is None:
        return
    host = torch.from_numpy(first[0])
    threaded = host.nbytes >= _STAGE_ON_THREAD_BYTES
    with span("ofc.stack"):
        slots = [torch.empty(host.shape, dtype=host.dtype, pin_memory=True) for _ in range(2)]
        if threaded:
            # The card waits for this copy, so it takes torch's threads.
            slots[0].copy_(host)
        else:
            np.copyto(slots[0].numpy(), first[0])
    released.put((1, None))

    def refill(got, batch):
        """Copy `batch` into the released slot once its last upload is done.
        numpy's copy runs on the calling thread alone: torch's would start a
        team of threads for each staging thread."""
        slot, upload = got
        if upload is not None:
            upload.synchronize()
        np.copyto(slots[slot].numpy(), batch)
        return slot

    if not threaded:
        yield 0, slots[0], first[1]
        for batch, n_valid in it:
            with span("ofc.stack"):
                slot = refill(released.get_nowait(), batch)
            yield slot, slots[slot], n_valid
        return

    ready: queue.Queue = queue.Queue()
    stop = threading.Event()

    def take():
        while not stop.is_set():
            try:
                return released.get(timeout=0.05)
            except queue.Empty:
                continue
        return None

    @torch.inference_mode()  # the slots were made in inference mode
    def worker():
        try:
            for batch, n_valid in it:
                got = take()
                if got is None:
                    return
                with span("ofc.stage"):
                    slot = refill(got, batch)
                ready.put((slot, slots[slot], n_valid))
            ready.put(_END)
        except Exception as e:  # noqa: BLE001 — raised again on the caller's side
            ready.put(e)

    t = threading.Thread(target=worker, name="ofc-stage", daemon=True)
    t.start()
    try:
        yield 0, slots[0], first[1]
        while True:
            with span("ofc.stack"):
                try:
                    item = ready.get_nowait()
                except queue.Empty:
                    CHUNK_COUNTS["stalls"] += 1
                    item = ready.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


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
