"""ctypes boundary to the port's C++ host-IO runtime (port of
`opticalflowclustering_tpu/io/fastio.py`): threaded batch PNG decode and
MJPEG-AVI demux/decode into one [N, H, W, 3] uint8 BGR buffer.

The runtime is the port's own `native/fastio.cpp`, which links no codec
library: its JPEG decoder gives the frames of the JAX package's libjpeg-turbo
configuration bit for bit, for 8-bit frames, Huffman-coded (SOF0, SOF1,
SOF2) and arithmetic-coded (SOF9, SOF10), sequential and progressive (block
smoothing of a frame cut short included), and its PNG decoder libpng's.
Lossless, differential and 12-bit frames, which libjpeg-turbo 2.1.5 does
not decode either, raise ValueError naming their SOF. It is
compiled with g++ alone at first use, never at import, into
`<repo>/.torch_ext_build/fastio/`, under a name keyed on a sha256 of the
source, the compiler's version and the command. One process builds while it
holds an `fcntl.flock` on a lock file there, writes to a temporary name and
`os.replace`s it into place, so test workers and `chip_smoke.py` that start
together neither race nor load a half-written library. A failed build raises
RuntimeError with the compiler's words, here and at every later call;
`available()` says whether the library loads.

`io.video.read_video_bgr(native=True)` and
`pipeline.bounce.process_video_stream(native=True)` send an MJPEG AVI here
and every other file to cv2. Their frames differ from cv2's (FFmpeg's
decoder) by a few codes, so the default stays cv2.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

from opticalflowclustering_tpu_torch.io.video import assemble_chunks
from opticalflowclustering_tpu_torch.utils.profiling import span

SRC = pathlib.Path(__file__).resolve().parents[1] / "native" / "fastio.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build" / "fastio"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_ERR_SOF = -0x10000  # minus (precision << 8 | SOF marker): an unsupported frame
_SOF_KINDS = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic sequential", 0xCA: "arithmetic progressive",
    0xCB: "arithmetic lossless", 0xCD: "arithmetic differential sequential",
    0xCE: "arithmetic differential progressive", 0xCF: "arithmetic differential lossless",
}

_lock = threading.Lock()
_lib = None
_error: str | None = None


def build_command(out: pathlib.Path | str) -> list[str]:
    """The g++ command that builds SRC into `out`: no codec library."""
    return ["g++", *FLAGS, str(SRC), "-o", str(out)]


def _library_path() -> pathlib.Path:
    """Where the library of this source, compiler and command lives."""
    try:
        version = subprocess.run(["g++", "-dumpfullversion"], capture_output=True, text=True,
                                 timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native fastio unavailable: g++ -dumpfullversion: {e}") from e
    key = hashlib.sha256(SRC.read_bytes() + f"\0{version}\0{' '.join(FLAGS)}".encode()).hexdigest()
    return BUILD_DIR / f"_fastio-{key[:16]}.so"


def _build() -> pathlib.Path:
    """The built library, compiling it first when this source, compiler and
    command have none yet. Raises RuntimeError with the compiler's stderr."""
    so = _library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tmp = BUILD_DIR / f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = build_command(tmp)
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(f"native fastio unavailable: {' '.join(cmd)}: {e}") from e
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native fastio unavailable: {' '.join(cmd)} exited "
                               f"{r.returncode}:\n{r.stderr.strip()}")
        os.replace(tmp, so)
        return so


def _load():
    """The loaded runtime, built at the first call. A failed build or load
    raises RuntimeError, and so does every later call, without a rebuild."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(_error)
        try:
            so = _build()
            lib = ctypes.CDLL(str(so))
        except (RuntimeError, OSError) as e:
            _error = str(e) if isinstance(e, RuntimeError) else f"native fastio unavailable: {e}"
            raise RuntimeError(_error) from e
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
        lib.ofc_decode_png_batch.restype = ctypes.c_int
        lib.ofc_decode_png_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, i32p,
        ]
        lib.ofc_mjpeg_avi_probe.restype = ctypes.c_int
        lib.ofc_mjpeg_avi_probe.argtypes = [ctypes.c_char_p, i32p, i32p, i32p]
        lib.ofc_mjpeg_avi_decode.restype = ctypes.c_int
        lib.ofc_mjpeg_avi_decode.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.ofc_mjpeg_avi_decode_flags.restype = ctypes.c_int
        lib.ofc_mjpeg_avi_decode_flags.argtypes = [
            ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, u8p,
        ]
        lib.ofc_acquire_fence.restype = None
        lib.ofc_acquire_fence.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native runtime loads (building it now if this is the
    first call in the process)."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def _threads() -> int:
    """Decode fan-out width: the host's cores. Every frame of a window
    decodes on its own, so the batch and the streaming MJPEG paths hand the
    whole window to fastio.cpp's parallel_for over frames."""
    return max(os.cpu_count() or 1, 1)


def _u8_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _decode_error(rc: int, what: str, path: str) -> ValueError:
    """The ValueError of a failed MJPEG decode; a frame of a kind the
    decoder does not take is named by its SOF marker."""
    if rc <= _ERR_SOF:
        code = _ERR_SOF - rc
        sof, precision = code & 0xFF, code >> 8
        kind = _SOF_KINDS.get(sof, "sequential Huffman")
        return ValueError(
            f"{what} failed: unsupported JPEG frame SOF{sof - 0xC0} ({kind}, {precision}-bit) in "
            f"{path}; the decoder takes 8-bit frames: Huffman (SOF0, SOF1, SOF2) and arithmetic (SOF9, SOF10)")
    return ValueError(f"{what} failed (rc={rc}): {path}")


def decode_png_batch(paths: list[str], h: int, w: int) -> np.ndarray:
    """Decode same-size PNGs → [N, h, w, 3] uint8 BGR in one native call. A
    file that is missing, no PNG or of another size raises ValueError."""
    lib = _load()
    n = len(paths)
    out = np.empty((n, h, w, 3), np.uint8)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    errs = (ctypes.c_int * n)()
    rc = lib.ofc_decode_png_batch(arr, n, _u8_ptr(out), h, w, _threads(), errs)
    if rc != 0:
        bad = [paths[i] for i in range(n) if errs[i] != 0][:3]
        raise ValueError(f"png batch decode failed (rc={rc}): {bad}")
    return out


def probe_mjpeg_avi(path: str) -> tuple[int, int, int] | None:
    """Full native probe (container and MJPEG codec): (n_frames, h, w) of
    the first frame's header, or None when the file is no MJPEG AVI. The
    gate of the native paths: an XVID AVI passes the RIFF sniff but not this
    probe. Raises RuntimeError when the runtime does not build."""
    lib = _load()
    n, h, w = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ofc_mjpeg_avi_probe(os.fsencode(path), ctypes.byref(n), ctypes.byref(h),
                                 ctypes.byref(w))
    if rc != 0 or n.value <= 0:
        return None
    return n.value, h.value, w.value


def is_mjpeg_avi(path: str) -> bool:
    """Cheap container sniff: the 12-byte RIFF/AVI magic. The codec is not
    checked (use probe_mjpeg_avi)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return False
    return len(head) == 12 and head[:4] == b"RIFF" and head[8:] == b"AVI "


def decode_mjpeg_avi(path: str, max_frames: int | None = None, threads: int | None = None) -> np.ndarray:
    """Demux and decode an MJPG AVI (`io.video.write_video_mjpg`'s format)
    → [N, H, W, 3] uint8 BGR, at most `max_frames`. Frames decode across the
    native thread pool, each into its own slice of the buffer, so the bytes
    are the same at any `threads` (default: the host's cores)."""
    lib = _load()
    probe = probe_mjpeg_avi(path)
    if probe is None:
        raise ValueError(f"not an MJPEG AVI: {path}")
    total, h, w = probe
    count = total if max_frames is None else max(min(total, max_frames), 0)
    out = np.empty((count, h, w, 3), np.uint8)
    if count == 0:
        return out
    got = lib.ofc_mjpeg_avi_decode(os.fsencode(path), _u8_ptr(out), count, h, w,
                                   _threads() if threads is None else max(threads, 1))
    if got < 0:
        raise _decode_error(got, "mjpeg decode", path)
    return out[:got]


class _Segment:
    """One in-flight decode window of `stream_mjpeg_avi`: a buffer the C++
    threads fill, from a thread of its own, and the per-frame done flags they
    publish (each release-ordered after its frame's pixels)."""

    def __init__(self, lib, path: str, start: int, count: int, h: int, w: int):
        self.lib, self.path, self.count = lib, path, count
        self.buf = np.empty((count, h, w, 3), np.uint8)
        self.done = np.zeros(count, np.uint8)
        self.result: list[int] = []
        self.thread = threading.Thread(target=self._work, args=(start, h, w), name="ofc-fastio",
                                       daemon=True)
        self.thread.start()

    def _work(self, start: int, h: int, w: int):
        self.result.append(self.lib.ofc_mjpeg_avi_decode_flags(
            os.fsencode(self.path), _u8_ptr(self.buf), start, self.count, h, w, _threads(),
            _u8_ptr(self.done)))

    def avail(self) -> int:
        """Length of the contiguous done prefix, followed by an acquire fence
        before any of its rows is read (plain numpy loads pair with the
        decoder's release fence on x86 only)."""
        nz = np.flatnonzero(self.done == 0)
        n = self.count if nz.size == 0 else int(nz[0])
        if n:
            self.lib.ofc_acquire_fence()
        return n

    def check_rc(self):
        if self.result and self.result[0] < 0:
            raise _decode_error(self.result[0], "mjpeg stream decode", self.path)


def stream_mjpeg_avi(
    path: str,
    chunk: int,
    overlap: int = 1,
    max_frames: int | None = None,
    segment: int | None = None,
    probe: tuple[int, int, int] | None = None,
):
    """Streaming native decode: yield ([chunk+overlap, H, W, 3] uint8 BGR,
    n_valid) batches, the contract of `io.video.stream_video_chunks`
    (assembled by `io.video.assemble_chunks`), while the C++ threads decode
    later frames in the background.

    A frame is passed on as soon as the contiguous done prefix covers it, so
    decode overlaps the caller's work on the previous batch. Frames decode
    in windows of `segment` frames (default ~128 MB of frames, at least
    chunk+overlap, at most 512); window k+1 starts decoding when window k's
    decode thread ends, and at most three window buffers are alive at once,
    so memory is bounded at any video length; each window reads only its own
    byte span of the file. A frame that fails to decode never publishes its
    flag: the stream stops there and raises ValueError, having yielded only
    the frames before it. `probe` passes on an earlier `probe_mjpeg_avi`
    result."""
    lib = _load()
    if probe is None:
        probe = probe_mjpeg_avi(path)
    if probe is None:
        raise ValueError(f"not an MJPEG AVI: {path}")
    total, h, w = probe
    if max_frames is not None:
        total = max(min(total, max_frames), 0)
    if segment is None:
        segment = max(1, min(512, (128 << 20) // max(h * w * 3, 1)))
    segment = max(segment, chunk + overlap)

    def frames_iter():
        start = 0
        cur = _Segment(lib, path, start, min(segment, total), h, w) if total else None
        start = cur.count if cur else 0
        while cur is not None:
            nxt = None
            emitted = 0
            while emitted < cur.count:
                avail = cur.avail()
                if nxt is None and start < total and not cur.thread.is_alive():
                    nxt = _Segment(lib, path, start, min(segment, total - start), h, w)
                    start += nxt.count
                if avail == emitted:
                    alive = cur.thread.is_alive()
                    # Scan again after the liveness check: the decoder may
                    # have published its last flags and exited in between.
                    avail = cur.avail()
                    if avail == emitted:
                        if not alive:
                            cur.check_rc()
                            raise ValueError(
                                f"mjpeg stream decode ended with an incomplete prefix "
                                f"({emitted}/{cur.count}): {path}")
                        with span("ofc.decode.wait"):
                            cur.thread.join(timeout=0.002)
                        continue
                for i in range(emitted, avail):
                    yield cur.buf[i]
                emitted = avail
            cur.thread.join()
            cur.check_rc()
            if nxt is None and start < total:
                nxt = _Segment(lib, path, start, min(segment, total - start), h, w)
                start += nxt.count
            cur = nxt

    yield from assemble_chunks(frames_iter(), chunk, overlap)
