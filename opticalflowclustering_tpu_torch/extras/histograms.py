"""Histogram demo workloads (port of
`opticalflowclustering_tpu/extras/histograms.py`; the reference is
`ColorHistograms/`, `GrayHistograms.py`, `2D-ColorHistograms.py`): thin
wrappers over ops.histogram on `device` that return the numpy arrays the
reference plots."""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.ops.histogram import calc_hist
from opticalflowclustering_tpu_torch.runtime import on_device


def gray_histogram(image_bgr, bins: int = 256, device: str | torch.device = "cuda") -> np.ndarray:
    """`GrayHistograms.py:12-14`."""
    gray = bgr2gray(on_device(image_bgr, device))
    return calc_hist(gray[..., None], [0], [bins], [(0, 256)]).cpu().numpy()


def channel_histograms(image_bgr, bins: int = 256, device: str | torch.device = "cuda") -> list[np.ndarray]:
    """`ColorHistograms.py:30-36`: per-channel 256-bin histograms (B, G, R)."""
    img = on_device(image_bgr, device)
    return [calc_hist(img, [c], [bins], [(0, 256)]).cpu().numpy() for c in range(3)]


def joint_histograms_2d(image_bgr, bins: int = 32, device: str | torch.device = "cuda") -> dict[str, np.ndarray]:
    """`2D-ColorHistograms.py:17-35`: G-B, G-R, B-R joint histograms."""
    img = on_device(image_bgr, device)
    pairs = {"gb": (1, 0), "gr": (1, 2), "br": (0, 2)}
    return {k: calc_hist(img, list(v), [bins, bins], [(0, 256), (0, 256)]).cpu().numpy() for k, v in pairs.items()}


def flattened_3d_histogram(image_bgr, bins: int = 8, device: str | torch.device = "cuda") -> np.ndarray:
    """`ColorHistograms.py` 3-D variant: [bins³] flattened feature."""
    img = on_device(image_bgr, device)
    return calc_hist(img, [0, 1, 2], [bins] * 3, [(0, 256)] * 3).cpu().numpy().ravel()
