"""Histogram primitives: cv2.calcHist / cv2.compareHist / normalize (port of
`opticalflowclustering_tpu/ops/histogram.py`).

Behind the reference's per-channel and joint colour histograms
(`ColorHistograms/ColorHistograms.py:32-36`, `2D-ColorHistograms.py:17-35`),
the CBIR feature extractor (`FirstImageSearchEngine/rgbhistogram.py:8-13`)
and the histogram-distance survey (`compare-histograms/comphis.py:27-40`).
A d-dimensional histogram maps pixels to flat bin ids and counts them with
one integer `bincount` on the tensor's device: exact counts, the same as
either of the JAX module's two accumulators.
"""

from __future__ import annotations

import numpy as np
import torch


def calc_hist(
    image: torch.Tensor,
    channels: list[int],
    bins: list[int],
    ranges: list[tuple[float, float]],
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """cv2.calcHist for one image: [..., H, W, C] uint8 → float32 histogram
    of shape `bins`. OpenCV's bin mapping: bin = floor((v - lo) · nbins /
    (hi - lo)), values at or above hi excluded."""
    ids, valid = _bin_ids(image, channels, bins, ranges)
    if mask is not None:
        valid &= mask.to(torch.bool)
    return torch.bincount(ids[valid], minlength=int(np.prod(bins))).to(torch.float32).reshape(bins)


def _bin_ids(image: torch.Tensor, channels, bins, ranges) -> tuple[torch.Tensor, torch.Tensor]:
    """Each pixel's flat bin id [..., H, W] int64 and whether it lies in
    every range."""
    x = image.to(torch.float32)
    ids = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    valid = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    stride = int(np.prod(bins))
    for ch, nb, (lo, hi) in zip(channels, bins, ranges):
        b = torch.floor((x[..., ch] - lo) * (nb / (hi - lo))).to(torch.int64)
        valid &= (b >= 0) & (b < nb)
        stride //= nb
        ids += torch.clamp(b, 0, nb - 1) * stride
    return ids, valid


def normalize_l2(hist: torch.Tensor) -> torch.Tensor:
    """cv2.normalize(hist, hist) default: L2 norm to 1."""
    n = torch.linalg.vector_norm(hist.ravel())
    return torch.where(n > 0, hist / n, hist)


def compare_hist(h1: torch.Tensor, h2: torch.Tensor, method: str) -> torch.Tensor:
    """cv2.compareHist: methods 'correl' | 'chisqr' | 'intersect' |
    'bhattacharyya' with OpenCV's formulas."""
    a = h1.ravel().to(torch.float32)
    b = h2.ravel().to(torch.float32)
    if method == "correl":
        am, bm = a - a.mean(), b - b.mean()
        denom = torch.sqrt((am * am).sum() * (bm * bm).sum())
        return torch.where(denom.abs() > 0, (am * bm).sum() / denom, 1.0)
    if method == "chisqr":
        return torch.where(a > 0, (a - b) ** 2 / a, 0.0).sum()
    if method == "intersect":
        return torch.minimum(a, b).sum()
    if method == "bhattacharyya":
        denom = torch.sqrt(a.sum() * b.sum())
        s = torch.where(denom > 0, torch.sqrt(a * b).sum() / denom, 0.0)
        return torch.sqrt(torch.clamp_min(1.0 - s, 0.0))
    raise ValueError(method)


def chi2_distance(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """The hand-rolled chi² of the search engines
    (`FirstImageSearchEngine/searcher.py:18-21`): 0.5 · Σ (a-b)²/(a+b+eps)
    over the last axis."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    return 0.5 * ((a - b) ** 2 / (a + b + eps)).sum(dim=-1)


def rgb_histogram_feature(image: torch.Tensor, bins=(8, 8, 8)) -> torch.Tensor:
    """`RGBHistogram.describe` (`rgbhistogram.py:8-13`): 3-D colour
    histogram, L2-normalized and flattened, the CBIR index feature."""
    return rgb_histogram_features(image[None], bins)[0]


def rgb_histogram_features(images: torch.Tensor, bins=(8, 8, 8)) -> torch.Tensor:
    """`rgb_histogram_feature` of every image of [N, H, W, 3] uint8 in one
    batched call → [N, prod(bins)] float32: one `bincount` over the images'
    bin ids offset by image, then each row's L2 normalization."""
    flat = int(np.prod(bins))
    ids, valid = _bin_ids(images, [0, 1, 2], list(bins), [(0, 256)] * 3)
    n = images.shape[0]
    ids = ids + torch.arange(n, device=ids.device).reshape((n,) + (1,) * (ids.ndim - 1)) * flat
    hist = torch.bincount(ids[valid], minlength=n * flat).to(torch.float32).reshape(n, flat)
    norm = torch.linalg.vector_norm(hist, dim=-1, keepdim=True)
    return torch.where(norm > 0, hist / norm, hist)
