"""Morphology: erode / dilate / open / close / gradient / tophat / blackhat
(port of `opticalflowclustering_tpu/ops/morphology.py`).

Min/max over the kernel's active offsets of a replicate-padded frame, on
the tensor's device: a rect kernel as two 1-D passes, any other kernel
(ellipse, cross) as one shifted slice per active cell. Only minimum and
maximum touch the values, so uint8 results are exact on every backend.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import pad_axis


def structuring_element(shape: str, ksize: tuple[int, int]) -> np.ndarray:
    """cv2.getStructuringElement: 'rect' | 'cross' | 'ellipse' (OpenCV's
    ellipse rasterization via the inscribed-ellipse row spans)."""
    kh, kw = ksize[1], ksize[0]  # cv2 takes (width, height)
    if shape == "rect":
        return np.ones((kh, kw), np.uint8)
    if shape == "cross":
        el = np.zeros((kh, kw), np.uint8)
        el[kh // 2, :] = 1
        el[:, kw // 2] = 1
        return el
    if shape == "ellipse":
        el = np.zeros((kh, kw), np.uint8)
        r, c = kh // 2, kw // 2
        inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
        for i in range(kh):
            j1, j2 = 0, 0
            dy = i - r
            if abs(dy) <= r:
                if r == 0:
                    j2 = kw
                else:
                    dx = int(round(c * np.sqrt(max(1.0 - dy * dy * inv_r2, 0.0))))
                    j1 = max(c - dx, 0)
                    j2 = min(c + dx + 1, kw)
                el[i, j1:j2] = 1
        return el
    raise ValueError(shape)


def _window_reduce(x: torch.Tensor, kernel: np.ndarray, is_max: bool) -> torch.Tensor:
    """Min/max of [..., H, W] over the kernel's active offsets, replicate
    border (the kernel's anchor at its centre, as OpenCV's default)."""
    kh, kw = kernel.shape
    ph, pw = kh // 2, kw // 2
    h, w = x.shape[-2], x.shape[-1]
    xp = pad_axis(pad_axis(x, -2, ph, kh - 1 - ph, "replicate"), -1, pw, kw - 1 - pw, "replicate")
    reduce = torch.maximum if is_max else torch.minimum
    acc = None
    for dy in range(kh):
        for dx in range(kw):
            if kernel[dy, dx]:
                sl = xp[..., dy : dy + h, dx : dx + w]
                acc = sl if acc is None else reduce(acc, sl)
    return acc


def _morph(x: torch.Tensor, kernel, iterations: int, is_max: bool) -> torch.Tensor:
    kernel = np.asarray(kernel)
    for _ in range(iterations):
        if kernel.all():
            x = _window_reduce(x, np.ones((kernel.shape[0], 1), np.uint8), is_max)
            x = _window_reduce(x, np.ones((1, kernel.shape[1]), np.uint8), is_max)
        else:
            x = _window_reduce(x, kernel, is_max)
    return x


def erode(x: torch.Tensor, kernel: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.erode of [..., H, W] with a replicate border."""
    return _morph(x, kernel, iterations, is_max=False)


def dilate(x: torch.Tensor, kernel: np.ndarray, iterations: int = 1) -> torch.Tensor:
    """cv2.dilate of [..., H, W] with a replicate border."""
    return _morph(x, kernel, iterations, is_max=True)


def morphology_ex(x: torch.Tensor, op: str, kernel: np.ndarray) -> torch.Tensor:
    """cv2.morphologyEx: 'open' | 'close' | 'gradient' | 'tophat' |
    'blackhat'."""
    if op == "open":
        return dilate(erode(x, kernel), kernel)
    if op == "close":
        return erode(dilate(x, kernel), kernel)
    if op == "gradient":
        return (dilate(x, kernel).int() - erode(x, kernel).int()).to(x.dtype)
    if op == "tophat":
        opened = dilate(erode(x, kernel), kernel)
        return (x.int() - opened.int()).clamp_min(0).to(x.dtype)
    if op == "blackhat":
        closed = erode(dilate(x, kernel), kernel)
        return (closed.int() - x.int()).clamp_min(0).to(x.dtype)
    raise ValueError(op)
