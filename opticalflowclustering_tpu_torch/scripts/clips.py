"""The bench clips, made with numpy alone (counterparts of `bench.py:52-73`,
which `scripts/profile_r4.py` draws its frames from)."""

from __future__ import annotations

import numpy as np

H, W = 720, 1280


def synth_frames(n: int, h: int = H, w: int = W, seed: int = 0) -> np.ndarray:
    """numpy-only smooth-motion clip [n, h, w, 3] uint8: a box-blurred random
    background and a filled disc that moves right and bobs. At 1280x720 it is
    the JAX bench's clip (bench.py:52-64: radius 25, 20 px/frame) with a 9x9
    box blur in place of cv2's Gaussian; other sizes scale it."""
    rng = np.random.default_rng(seed)
    k = 9
    bg = rng.integers(0, 256, (h, w, 3)).astype(np.float64)
    bg = np.pad(bg, ((k // 2, k // 2), (k // 2, k // 2), (0, 0)), mode="edge")
    c = np.pad(bg.cumsum(0).cumsum(1), ((1, 0), (1, 0), (0, 0)))
    bg = ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.repeat(bg[None], n, axis=0)
    sx, sy = w / 1280, h / 720
    for i in range(n):
        cx, cy = (100 + 20 * i) * sx, (300 + int(8 * np.sin(i / 3))) * sy
        frames[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= (25 * sy) ** 2] = (40, 200, 220)
    return frames


def noise_frames(n: int, h: int = H, w: int = W, seed: int = 7) -> np.ndarray:
    """Independent uniform noise per frame (bench.py:67-73)."""
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)
