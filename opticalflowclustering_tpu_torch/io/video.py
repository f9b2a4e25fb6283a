"""Host video decode and encode (port of `opticalflowclustering_tpu/io/video.py`).

A video is decoded on the host by OpenCV, either at once into one batched
uint8 array (`read_video_bgr`) or chunk by chunk on a background thread
(`stream_video_chunks`), so that decode overlaps the card's work on the
previous chunk. Encode mirrors `cv2.VideoWriter` with the reference's MJPG
fourcc (`computeOpticalFlow.py:27-33`). cv2 is imported inside the functions
that decode or encode, so importing this module loads neither cv2 nor any
part of the JAX package. `native=True` sends an MJPEG AVI to the port's
threaded C++ decoder (`io.fastio`, no codec library; its frames are the JAX
package's native decoder's and differ from cv2's by a few codes) and every
other file to cv2. `VideoStream` is the real-time demo's paced threaded
source.
"""

from __future__ import annotations

import queue
import threading
import time
from collections.abc import Iterable, Iterator

import numpy as np

from opticalflowclustering_tpu_torch.utils.profiling import span

_LFS_POINTER_MAGIC = b"version https://git-lfs.github.com/spec/v1"


def is_lfs_pointer(path: str) -> bool:
    """True if `path` is a Git-LFS pointer stub rather than real media."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(_LFS_POINTER_MAGIC))
    except OSError:
        return False
    return head == _LFS_POINTER_MAGIC


def _cv2_frames(path: str, max_frames: int | None) -> Iterator[np.ndarray]:
    """[H, W, 3] uint8 BGR frames of `path`, at most `max_frames`. The file is
    opened at the first `next()`, on the thread that iterates, and released
    when the generator ends or is closed."""
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise FileNotFoundError(f"cannot open video: {path}")
        decoded = 0
        while max_frames is None or decoded < max_frames:
            ret, frame = cap.read()
            if not ret:
                return
            decoded += 1
            yield frame
    finally:
        cap.release()


def read_video_bgr(path: str, max_frames: int | None = None, native: bool = False) -> np.ndarray:
    """Decode a video file with cv2 → [N, H, W, 3] uint8 BGR frames (at most
    `max_frames`).

    native=True decodes an MJPEG AVI with the threaded C++ decoder
    (`io.fastio.decode_mjpeg_avi`) instead: its JPEG rounding differs from
    cv2's by up to 5 codes (mean < 1), so golden-parity paths keep cv2. The
    gate is the JAX package's: the 12-byte RIFF sniff, then the full container
    and codec probe. A file that fails either (an mp4, an XVID AVI) decodes
    with cv2; an MJPEG AVI decodes natively or raises (a decoder that does
    not build raises RuntimeError)."""
    if native:
        from opticalflowclustering_tpu_torch.io import fastio

        if fastio.is_mjpeg_avi(path) and fastio.probe_mjpeg_avi(path):
            return fastio.decode_mjpeg_avi(path, max_frames)
    frames = list(_cv2_frames(path, max_frames))
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def video_fps(path: str) -> float:
    """The container's frame rate, or 30.0 where it reports none."""
    import cv2

    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps) if fps and fps > 0 else 30.0


def assemble_chunks(frames_iter: Iterator[np.ndarray], chunk: int, overlap: int):
    """The chunk/carry/pad contract of every streaming path: consume an
    iterator of [H, W, 3] uint8 frames and yield ([chunk+overlap, H, W, 3],
    n_valid) batches, where consecutive batches share `overlap` frames and
    the last batch is zero-padded to the fixed shape (n_valid counts its
    real frames beyond the overlap)."""
    carry: list[np.ndarray] = []
    eof = False
    while not eof:
        frames = list(carry)
        while len(frames) < chunk + overlap:
            nxt = next(frames_iter, None)
            if nxt is None:
                eof = True
                break
            frames.append(nxt)
        n_valid = max(0, len(frames) - overlap)
        if n_valid == 0:
            break
        with span("ofc.stack"):
            batch = np.zeros((chunk + overlap,) + frames[0].shape, np.uint8)
            batch[: len(frames)] = np.stack(frames)
        yield batch, n_valid
        carry = frames[chunk:]


_END = object()


def prefetch_chunks(
    frames: Iterable[np.ndarray],
    chunk: int,
    overlap: int = 1,
    prefetch: int = 2,
):
    """Yield `assemble_chunks` batches of `frames`, assembled `prefetch`
    batches ahead by a background thread behind a bounded queue, so the
    source (a decoder, or frames already in memory) runs while the caller
    works on the previous batch.

    The thread touches only host memory. An exception of the source is
    raised on the caller's side. When the caller stops early (closes this
    generator), the thread stops at its next frame or queue slot, the source
    is closed (a generator's `finally` runs, releasing its file) and the
    thread is joined."""
    source = iter(frames)
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def until_stopped():
        for frame in source:
            if stop.is_set():
                return
            yield frame

    def worker():
        try:
            batches = assemble_chunks(until_stopped(), chunk, overlap)
            while True:
                with span("ofc.decode"):
                    item = next(batches, _END)
                if item is _END:
                    break
                if not put(item):
                    return
            put(_END)
        except Exception as e:  # noqa: BLE001 — raised again on the caller's side
            put(e)
        finally:
            close = getattr(source, "close", None)
            if close is not None:
                close()

    t = threading.Thread(target=worker, name="ofc-prefetch", daemon=True)
    t.start()
    try:
        while True:
            with span("ofc.decode.wait"):
                item = q.get()
            if item is _END:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join()


def stream_video_chunks(
    path: str,
    chunk: int,
    overlap: int = 1,
    max_frames: int | None = None,
    prefetch: int = 2,
):
    """Yield ([chunk+overlap, H, W, 3] uint8, n_valid) batches of `path`,
    decoded by cv2 on a background thread (`prefetch_chunks`): the next chunk
    decodes while the card works on the current one (the reference decodes
    inside its hot loop, `KmeanGrids.py:180-185`). A decode error is raised
    on the consumer's side."""
    return prefetch_chunks(_cv2_frames(path, max_frames), chunk, overlap, prefetch)


class VideoStream:
    """Threaded frame source, the imutils.video.VideoStream analogue the
    real-time demo builds on (`real-time-object-detection-with-deep-learning
    -and-opencv/real_time_object_detection.py:29`): a daemon thread reads
    frames as fast as the source produces them and `read()` returns the
    latest one. `src` is a camera index or a video path; files are paced at
    their native fps (`paced=None`), so they behave like a live source."""

    def __init__(self, src: int | str = 0, paced: bool | None = None):
        import cv2

        self._cap = cv2.VideoCapture(src)
        if not self._cap.isOpened():
            raise FileNotFoundError(f"cannot open stream source: {src}")
        self._paced = paced if paced is not None else isinstance(src, str)
        self._fps = self._cap.get(cv2.CAP_PROP_FPS) or 30.0
        self._frame: np.ndarray | None = None
        self._stopped = threading.Event()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="ofc-videostream", daemon=True)

    def start(self) -> "VideoStream":
        self._thread.start()
        return self

    def _loop(self):
        interval = 1.0 / max(self._fps, 1e-3)
        try:
            while not self._stopped.is_set():
                t0 = time.time()
                ret, frame = self._cap.read()
                if not ret:
                    break
                self._frame = frame
                self._ready.set()
                if self._paced:
                    time.sleep(max(0.0, interval - (time.time() - t0)))
        finally:
            self._stopped.set()
            self._cap.release()

    def read(self, timeout: float = 5.0) -> np.ndarray | None:
        """Latest frame, or None before the first frame arrives within
        `timeout` on a source that yields none."""
        if self._frame is None and not self._stopped.is_set():
            self._ready.wait(timeout)
        return self._frame

    def running(self) -> bool:
        return not self._stopped.is_set()

    def stop(self) -> None:
        """Stop the reader thread and wait (up to 5 s) for it to release the
        source."""
        self._stopped.set()
        if self._thread.is_alive():
            self._thread.join(5.0)


def write_video_mjpg(path: str, frames: np.ndarray, fps: float) -> None:
    """Encode [N, H, W, 3] uint8 BGR frames as MJPG, the reference's writer
    configuration (`computeOpticalFlow.py:27-33`, `KmeanGrids.py:163`)."""
    import cv2

    h, w = frames.shape[1], frames.shape[2]
    out = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    try:
        for f in np.asarray(frames):
            out.write(f)
    finally:
        out.release()
