"""Thresholding / masking primitives: cv2.threshold, adaptiveThreshold,
inRange, bitwise masking (port of `opticalflowclustering_tpu/ops/threshold.py`).

Reference call sites: the global threshold modes
(`ImageSegmentation/threshold.py:14-23`), adaptive document binarization
(`DocumentScanner/scan.py:47`, `Pokedex/search.py:24-25`), colour and skin
masks (`color-detection/detect_color.py:22-23`). Elementwise on the tensor's
device; the adaptive threshold's local mean is the port's separable filter
in the reference's pair-summation order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import gaussian_kernel, sep_filter_axis
from opticalflowclustering_tpu_torch.runtime import f32


def _u8(cond: torch.Tensor, a, b) -> torch.Tensor:
    """where(cond, a, b) as uint8, a and b uint8 tensors or ints."""
    return torch.where(cond, a, b).to(torch.uint8)


def threshold(src: torch.Tensor, thresh: float, maxval: float, mode: str = "binary") -> torch.Tensor:
    """cv2.threshold (uint8 path). Returns the thresholded image (OpenCV
    also returns `thresh`; use `threshold_otsu` for the Otsu value)."""
    t, m = int(thresh), int(maxval)
    above = src.to(torch.int32) > t
    if mode == "binary":
        return _u8(above, m, 0)
    if mode == "binary_inv":
        return _u8(above, 0, m)
    src = src.to(torch.uint8)
    if mode == "trunc":
        return _u8(above, t, src)
    if mode == "tozero":
        return _u8(above, src, 0)
    if mode == "tozero_inv":
        return _u8(above, 0, src)
    raise ValueError(mode)


def threshold_otsu(src: torch.Tensor) -> torch.Tensor:
    """Otsu's threshold value for a uint8 image (cv2.THRESH_OTSU): the bin
    that maximizes the between-class variance of the 256-bin histogram, as
    a float32 scalar tensor."""
    hist = torch.bincount(src.to(torch.int64).ravel(), minlength=256).to(torch.float32)
    w = hist / hist.sum()
    bins = torch.arange(256, dtype=torch.float32, device=src.device)
    omega = torch.cumsum(w, 0)
    mu = torch.cumsum(w * bins, 0)
    denom = omega * (1.0 - omega)
    sigma_b = torch.where(denom > 0, (mu[-1] * omega - mu) ** 2 / denom, 0.0)
    return torch.argmax(sigma_b).to(torch.float32)


def adaptive_threshold(
    src: torch.Tensor,
    maxval: float = 255,
    method: str = "mean",
    mode: str = "binary",
    block_size: int = 11,
    c: float = 2.0,
) -> torch.Tensor:
    """cv2.adaptiveThreshold semantics: the local mean is a box/Gaussian
    filter with REPLICATE border rounded to uint8 (half to even), and the
    comparison is src > mean - ceil(C) for binary (floor for binary_inv),
    as OpenCV builds its integer table."""
    x = src.to(torch.float32)
    if method == "mean":
        k = np.full(block_size, 1.0 / block_size)
    elif method == "gaussian":
        k = gaussian_kernel(block_size, 0.0)
    else:
        raise ValueError(method)
    local = sep_filter_axis(sep_filter_axis(x, k, axis=-2, border="replicate"), k, axis=-1, border="replicate")
    mean_u8 = torch.clamp(torch.round(local), 0, 255)
    m = int(maxval)
    if mode == "binary":
        return _u8(x > mean_u8 - f32(math.ceil(c)), m, 0)
    if mode == "binary_inv":
        return _u8(x > mean_u8 - f32(math.floor(c)), 0, m)
    raise ValueError(mode)


def in_range(src: torch.Tensor, lower, upper) -> torch.Tensor:
    """cv2.inRange: 255 where every channel is within [lower, upper]."""
    lo = torch.tensor(lower, dtype=src.dtype).to(src.device)
    hi = torch.tensor(upper, dtype=src.dtype).to(src.device)
    return _u8(((src >= lo) & (src <= hi)).all(dim=-1), 255, 0)


def bitwise_and_mask(src: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """cv2.bitwise_and(src, src, mask=mask)."""
    return torch.where((mask > 0)[..., None], src, torch.zeros((), dtype=src.dtype, device=src.device))
