"""Gradient / edge primitives: Sobel, Scharr, Laplacian, Canny, bilateral
(port of `opticalflowclustering_tpu/ops/edges.py`).

Reference call sites: barcode gradients (`detect-barcodes/detect_barcode.py:
12-13`, Scharr via ksize=-1), document edges (`DocumentScanner/scan.py:20`,
Canny 75/200), Game Boy screen finding (`Pokedex/find_screen.py:18-19`,
bilateralFilter(11,17,17) + Canny 30/200).

Sobel/Scharr are separable shifted-slice correlations in the reference's
float32 order (REFLECT_101 border, like OpenCV). Canny is the whole
pipeline in integers: Sobel gradients, cv2's fixed-point 4-sector
non-maximum suppression, the double threshold, and hysteresis as a
fixpoint of 8-neighbour growth of the strong edges inside the weak ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import pad_axis, sep_filter_axis
from opticalflowclustering_tpu_torch.runtime import f32

_INT32 = (-(2**31), 2**31 - 1)
# Hysteresis steps between two convergence checks: each check is a host
# sync on the card, and extra steps at the fixpoint change nothing.
_HYSTERESIS_CHECK = 8


def _deriv_kernels(order: int, ksize: int) -> np.ndarray:
    """cv2.getDerivKernels column for one axis (smoothing if order=0)."""
    if ksize == -1:  # Scharr
        return np.array([3.0, 10.0, 3.0]) if order == 0 else np.array([-1.0, 0.0, 1.0])
    if ksize == 1:
        return np.array([1.0]) if order == 0 else np.array([-1.0, 0.0, 1.0])
    # Pascal's-triangle construction (OpenCV getDerivKernels).
    k = np.array([1.0])
    for _ in range(ksize - 1 - order):
        k = np.convolve(k, [1.0, 1.0])
    for _ in range(order):
        k = np.convolve(k, [1.0, -1.0])
    return k[::-1]


def sobel(img: torch.Tensor, dx: int, dy: int, ksize: int = 3, border: str = "reflect101") -> torch.Tensor:
    """cv2.Sobel(img, CV_32F, dx, dy, ksize) / cv2.Scharr when ksize=-1.
    [..., H, W] → float32. `border` defaults to cv2.Sobel's
    (BORDER_REFLECT_101); cv2.Canny's internal Sobel uses 'replicate'."""
    x = sep_filter_axis(img.to(torch.float32), _deriv_kernels(dy, ksize), axis=-2, border=border)
    return sep_filter_axis(x, _deriv_kernels(dx, ksize), axis=-1, border=border)


def _pad2(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    return pad_axis(pad_axis(x, -2, r, r, mode), -1, r, r, mode)


def _pad_zero(x: torch.Tensor) -> torch.Tensor:
    """[..., H, W] with one row and column of zeros (False) around it."""
    out = torch.zeros(x.shape[:-2] + (x.shape[-2] + 2, x.shape[-1] + 2), dtype=x.dtype, device=x.device)
    out[..., 1:-1, 1:-1] = x
    return out


def laplacian(img: torch.Tensor, ksize: int = 1) -> torch.Tensor:
    """cv2.Laplacian(img, CV_32F): sum of second derivatives."""
    if ksize != 1:
        return sobel(img, 2, 0, ksize) + sobel(img, 0, 2, ksize)
    k = np.array([[0, 1, 0], [1, -4, 1], [0, 1, 0]], np.float32)
    x = img.to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    xp = _pad2(x, 1, "reflect101")
    acc = torch.zeros_like(x)
    for i in range(3):
        for j in range(3):
            if k[i, j]:
                acc = acc + f32(k[i, j]) * xp[..., i : i + h, j : j + w]
    return acc


def canny(
    img: torch.Tensor,
    threshold1: float,
    threshold2: float,
    l2gradient: bool = False,
    hysteresis_iters: int = 64,
) -> torch.Tensor:
    """cv2.Canny for a uint8 [..., H, W] image → uint8 edge map {0, 255}.

    The reference's bit-exact re-derivation of OpenCV's aperture-3 path:
    Sobel-3 gradients with BORDER_REPLICATE (cv2.Canny's internal border);
    the integer L1 magnitude, or the int32 squared magnitude with
    l2gradient, against integer thresholds converted in cv2's order (swap
    so low <= high; for L2 clip each to 2^15-1 and square only positive
    values; then floor), here clamped to int32 so that a huge threshold
    compares as it would unbounded; cv2's fixed-point sector NMS (|gy|·2^15
    against |gx|·13573 and |gx|·13573 + |gx|·2^16, which fit in int32 for
    |g| <= 1020) with (>, >=) ties horizontally and vertically and strict >
    on the diagonals; hysteresis to its fixpoint, zero magnitude outside
    the image.

    `hysteresis_iters` is accepted and unused, as in the reference, whose
    `lax.while_loop` also runs to the fixpoint."""
    lo_f, hi_f = min(threshold1, threshold2), max(threshold1, threshold2)
    if l2gradient:
        lo_f, hi_f = min(32767.0, lo_f), min(32767.0, hi_f)
        if lo_f > 0:
            lo_f *= lo_f
        if hi_f > 0:
            hi_f *= hi_f
    low, high = (min(max(math.floor(v), _INT32[0]), _INT32[1]) for v in (lo_f, hi_f))
    gx = sobel(img, 1, 0, 3, border="replicate").to(torch.int32)
    gy = sobel(img, 0, 1, 3, border="replicate").to(torch.int32)
    mag = gx * gx + gy * gy if l2gradient else gx.abs() + gy.abs()

    h, w = mag.shape[-2], mag.shape[-1]
    mp = _pad_zero(mag)

    def nb(dy, dx):
        return mp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    ax, ay = gx.abs(), gy.abs() << 15
    tg22x = ax * 13573
    tg67x = tg22x + (ax << 16)
    horiz = ay < tg22x  # gradient mostly horizontal: compare left/right
    vert = ay > tg67x  # mostly vertical: compare up/down
    diag1 = ((gx ^ gy) >= 0) & ~horiz & ~vert
    keep = torch.where(
        horiz,
        (mag > nb(0, -1)) & (mag >= nb(0, 1)),
        torch.where(
            vert,
            (mag > nb(-1, 0)) & (mag >= nb(1, 0)),
            torch.where(diag1, (mag > nb(-1, -1)) & (mag > nb(1, 1)), (mag > nb(-1, 1)) & (mag > nb(1, -1))),
        ),
    )
    cur = keep & (mag > high)
    weak = keep & (mag > low)
    # Each step grows the strong set by its 8-neighbours inside the weak set:
    # monotone, and a no-op at the fixpoint, so checking for convergence only
    # every few steps gives the same edges.
    while True:
        prev = cur
        for _ in range(_HYSTERESIS_CHECK):
            cp = _pad_zero(cur)
            grown = cur.clone()
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    if dy or dx:
                        grown |= cp[..., 1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
            cur = grown & weak
        if torch.equal(cur, prev):
            break
    return torch.where(cur, 255, 0).to(torch.uint8)


def bilateral_filter(img: torch.Tensor, d: int, sigma_color: float, sigma_space: float) -> torch.Tensor:
    """cv2.bilateralFilter for uint8/float [..., H, W] (grayscale) or
    [..., H, W, C]: windowed Gaussian in space × Gaussian in intensity over
    the disc of radius d//2, REFLECT_101 border."""
    chan = img.ndim >= 3 and img.shape[-1] in (1, 3)
    x = img.to(torch.float32)
    if not chan:
        x = x[..., None]
    r = d // 2
    gauss_color = f32(-0.5 / (sigma_color * sigma_color))
    h, w = x.shape[-3], x.shape[-2]
    xp = pad_axis(pad_axis(x, -3, r, r, "reflect101"), -2, r, r, "reflect101")
    num = torch.zeros_like(x)
    den = torch.zeros(x.shape[:-1] + (1,), dtype=torch.float32, device=x.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue
            sw = f32(np.exp((dy * dy + dx * dx) * -0.5 / (sigma_space * sigma_space)))
            nbr = xp[..., r + dy : r + dy + h, r + dx : r + dx + w, :]
            diff = (nbr - x).abs().sum(dim=-1, keepdim=True)
            wgt = sw * torch.exp(diff * diff * gauss_color)
            num = num + wgt * nbr
            den = den + wgt
    out = num / den
    if not chan:
        out = out[..., 0]
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out
