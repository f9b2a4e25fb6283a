"""Host video decode (port of `opticalflowclustering_tpu/io/video.py`).

A video is decoded once on the host by OpenCV into one batched uint8 array,
which crosses to the device chunk by chunk. cv2 is imported inside the
function that decodes, so importing this module loads neither cv2 nor any
part of the JAX package. The JAX package's `native=True` branch (its C++
MJPEG decoder, whose rounding differs from cv2's) has no counterpart here.
"""

from __future__ import annotations

import numpy as np

_LFS_POINTER_MAGIC = b"version https://git-lfs.github.com/spec/v1"


def is_lfs_pointer(path: str) -> bool:
    """True if `path` is a Git-LFS pointer stub rather than real media."""
    try:
        with open(path, "rb") as f:
            head = f.read(len(_LFS_POINTER_MAGIC))
    except OSError:
        return False
    return head == _LFS_POINTER_MAGIC


def read_video_bgr(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode a video file with cv2 → [N, H, W, 3] uint8 BGR frames (at most
    `max_frames`)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {path}")
    frames = []
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        frames.append(frame)
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)
