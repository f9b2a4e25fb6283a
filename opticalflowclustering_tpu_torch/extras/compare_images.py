"""Image comparison workload (port of
`opticalflowclustering_tpu/extras/compare_images.py`; the reference is
`CompareTwoImages/compare.py:13-28`): the MSE and SSIM pair, returned
instead of plotted."""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.ops.ssim import mse, ssim
from opticalflowclustering_tpu_torch.runtime import on_device


def compare_images(image_a, image_b, device: str | torch.device = "cuda") -> tuple[float, float]:
    """(mse, ssim) of two grayscale images on `device`: the metrics
    `compare_images` titles its figure with."""
    a = on_device(image_a, device)
    b = on_device(image_b, device)
    return float(mse(a, b)), float(ssim(a, b))
