"""MSE and SSIM image comparison (port of `opticalflowclustering_tpu/ops/ssim.py`;
the reference is `CompareTwoImages/compare.py:7-28`).

SSIM follows scikit-image's `structural_similarity` defaults for uint8
inputs: a 7×7 uniform window, sample-covariance normalization N/(N-1),
data_range 255, K1=0.01, K2=0.03, the mean over the border-cropped region.
The windowed means are the port's separable filter, reflect-101 border.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import sep_filter_axis
from opticalflowclustering_tpu_torch.runtime import f32


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`compare.py mse:7-10`: mean squared error in float32."""
    return ((a.to(torch.float32) - b.to(torch.float32)) ** 2).mean()


def _uniform(x: torch.Tensor, win: int) -> torch.Tensor:
    k = np.full(win, 1.0 / win)
    return sep_filter_axis(sep_filter_axis(x, k, axis=-2, border="reflect101"), k, axis=-1, border="reflect101")


def ssim(
    a: torch.Tensor,
    b: torch.Tensor,
    win_size: int = 7,
    data_range: float = 255.0,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over the valid (border-cropped) region, skimage-default
    semantics. a, b: [..., H, W] grayscale."""
    x = a.to(torch.float32)
    y = b.to(torch.float32)
    np_win = win_size * win_size
    cov_norm = f32(np_win / (np_win - 1.0))
    ux, uy = _uniform(x, win_size), _uniform(y, win_size)
    uxx, uyy, uxy = _uniform(x * x, win_size), _uniform(y * y, win_size), _uniform(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1, c2 = f32((k1 * data_range) ** 2), f32((k2 * data_range) ** 2)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux * ux + uy * uy + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return s[..., pad:-pad, pad:-pad].mean()
