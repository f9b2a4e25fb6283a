"""The one generator of every traffic mix's clips, from `--seed`.

A mix names its source: "demo" is the cropped table-tennis clip committed
beside this file (`data/601_3.avi`, 75 MJPEG frames of 232×220, the
upstream's `601_3` crop), "noise" is uniform noise. For each clip the seed
picks a start frame, a left-right mirror and a playing direction, and, where
the configuration's frame is larger than the source, the phase at which the
source frame is tiled over it. Every seed gives the same number of clips of
the same size: the seed changes what the frames show, not how much work
they are.

File mixes write each clip as an MJPEG AVI (cv2's JPEG encoder at the mix's
quality, muxed here) into a directory the caller owns.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ofc_bench.spec import HERE

DEMO = HERE / "data" / "601_3.avi"


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent generator per use of the seed (clips, sampling)."""
    return np.random.default_rng([seed % 2**64, stream])


def read_avi(path: str | os.PathLike) -> np.ndarray:
    """Every frame of a video file decoded by cv2 → [N, H, W, 3] uint8 BGR."""
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
    finally:
        cap.release()
    if not frames:
        raise RuntimeError(f"cv2 decoded no frame of {path}")
    return np.stack(frames)


def make_clips(config: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    """`traffic['clips']` clips of `config['clip_frames']` frames of
    config['height'] × config['width']."""
    rng = rng_for(seed, 0)
    n, h, w = config["clip_frames"], config["height"], config["width"]
    if traffic.get("source", "demo") == "noise":
        return [rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8) for _ in range(traffic["clips"])]
    src = read_avi(DEMO)
    sn, sh, sw = src.shape[:3]
    if n > sn:
        raise ValueError(f"clips of {n} frames from a source of {sn}")
    clips = []
    for _ in range(traffic["clips"]):
        c = {"start": int(rng.integers(0, sn - n + 1)), "mirror": bool(rng.integers(0, 2)),
             "reverse": bool(rng.integers(0, 2)), "phase": (int(rng.integers(0, sh)), int(rng.integers(0, sw)))}
        frames = src[c["start"] : c["start"] + n]
        if c["reverse"]:
            frames = frames[::-1]
        if c["mirror"]:
            frames = frames[:, :, ::-1]
        frames = np.ascontiguousarray(frames)
        if (h, w) != (sh, sw):  # tiled: columns first, on the smaller array
            frames = np.take(np.take(frames, (np.arange(w) + c["phase"][1]) % sw, axis=2),
                             (np.arange(h) + c["phase"][0]) % sh, axis=1)
        clips.append(frames)
    return clips


def write_mjpeg_avi(path: str | os.PathLike, frames: np.ndarray, quality: int, fps: int = 30) -> None:
    """An MJPEG AVI of `frames` [N, H, W, 3] uint8 BGR: each frame a baseline
    4:2:0 JPEG from cv2 at `quality`, in a RIFF 'AVI ' with one 'vids' MJPG
    stream, a movi list of '00dc' chunks and an idx1 index."""
    import cv2

    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    jpegs = []
    for f in frames:
        ok, buf = cv2.imencode(".jpg", f, params)
        if not ok:
            raise RuntimeError("cv2 did not encode a frame")
        jpegs.append(buf.tobytes())
    n, h, w = frames.shape[:3]

    def chunk(tag, data):
        return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def group(kind, body):
        return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body

    largest = max(len(j) for j in jpegs)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1, largest, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, largest, 0xFFFFFFFF, 0,
                                     0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = group(b"hdrl", chunk(b"avih", avih) + group(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index, offset = [], [], 4
    for j in jpegs:
        movi.append(chunk(b"00dc", j))
        index.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))  # AVIIF_KEYFRAME
        offset += len(movi[-1])
    body = hdrl + group(b"movi", b"".join(movi)) + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)
