"""Separable filters (GaussianBlur, box sum) as sums of shifted slices
(port of `opticalflowclustering_tpu/ops/filters.py`).

Borders are built by indexing the axis with numpy's own pad indices, so
reflect101 and replicate mean exactly what `jnp.pad` means in the reference.
Sums run in OpenCV's symmetric-pair order (centre + Σ w[k]·(left_k + right_k)).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import f32

# OpenCV getGaussianKernel: fixed kernels for small ksize when sigma<=0.
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0]),
    3: np.array([0.25, 0.5, 0.25]),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625]),
    7: np.array([0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]),
}

_NP_PAD_MODE = {"reflect101": "reflect", "replicate": "edge"}


@functools.lru_cache(maxsize=64)
def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) in float64.

    sigma<=0 uses OpenCV's fixed small-kernel table (ksize<=7) or the
    derived sigma 0.3*((ksize-1)*0.5 - 1) + 0.8.
    """
    if sigma <= 0 and ksize <= 7:
        return _SMALL_GAUSSIAN_TAB[ksize].copy()
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def pad_axis(
    x: torch.Tensor, axis: int, before: int, after: int, mode: str
) -> torch.Tensor:
    """`x` padded along `axis` with OpenCV's reflect101 or replicate border."""
    if mode not in _NP_PAD_MODE:
        raise ValueError(mode)
    n = x.shape[axis]
    idx = np.pad(np.arange(n), (before, after), mode=_NP_PAD_MODE[mode])
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def sep_filter_axis(
    x: torch.Tensor, kernel: np.ndarray, axis: int, border: str = "reflect101"
) -> torch.Tensor:
    """Correlate one axis with a 1-D kernel, symmetric-pair summation order."""
    k = len(kernel)
    r = k // 2
    axis = axis % x.ndim
    xp = pad_axis(x.to(torch.float32), axis, r, r, border)
    n = x.shape[axis]

    def sl(off):
        return xp.narrow(axis, off, n)

    symmetric = k % 2 == 1 and all(
        math.isclose(kernel[r - i], kernel[r + i]) for i in range(1, r + 1)
    )
    if symmetric:
        acc = f32(kernel[r]) * sl(r)
        for i in range(1, r + 1):
            acc = acc + f32(kernel[r - i]) * (sl(r - i) + sl(r + i))
        return acc
    acc = f32(kernel[0]) * sl(0)
    for i in range(1, k):
        acc = acc + f32(kernel[i]) * sl(i)
    return acc


def gaussian_blur(
    x: torch.Tensor,
    ksize: int,
    sigma: float,
    border: str = "reflect101",
    axes: tuple[int, int] = (-2, -1),
) -> torch.Tensor:
    """cv2.GaussianBlur(x, (ksize,ksize), sigma) over the two spatial axes."""
    k = gaussian_kernel(ksize, sigma)
    x = sep_filter_axis(x, k, axes[0], border)
    return sep_filter_axis(x, k, axes[1], border)


def box_sum(
    x: torch.Tensor,
    ksize: int,
    border: str = "replicate",
    axes: tuple[int, int] = (-2, -1),
) -> torch.Tensor:
    """Un-normalized ksize×ksize box sum with replicate border (Farneback's
    windowed accumulation of M, divided by ksize² at solve time)."""
    ones = np.ones(ksize, dtype=np.float64)
    x = sep_filter_axis(x, ones, axes[0], border)
    return sep_filter_axis(x, ones, axes[1], border)
