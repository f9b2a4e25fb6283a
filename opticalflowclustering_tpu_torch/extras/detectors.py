"""Detection demo workloads (port of
`opticalflowclustering_tpu/extras/detectors.py`; the references are
`color-detection/detect_color.py`, `skin-detection/skindetector.py`,
`finding-brightest-spot/bright.py`, `detect-barcodes/detect_barcode.py` and
`finding-shapes/find_shapes.py`). The mask math runs on `device`; the
irregular contour step stays on the host (extras.contours).
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.extras.contours import (
    box_points,
    contour_area,
    find_external_contours,
    min_area_rect,
)
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray, bgr2hsv
from opticalflowclustering_tpu_torch.ops.edges import sobel
from opticalflowclustering_tpu_torch.ops.filters import gaussian_blur, sep_filter_axis
from opticalflowclustering_tpu_torch.ops.morphology import dilate, erode, morphology_ex, structuring_element
from opticalflowclustering_tpu_torch.ops.threshold import bitwise_and_mask, in_range, threshold
from opticalflowclustering_tpu_torch.runtime import on_device

# The four colour bands of `detect_color.py:11-16` (BGR lower/upper).
COLOR_BOUNDARIES = [
    ((17, 15, 100), (50, 56, 200)),  # red
    ((86, 31, 4), (220, 88, 50)),  # blue
    ((25, 146, 190), (62, 174, 250)),  # yellow
    ((103, 86, 65), (145, 133, 128)),  # gray
]


def _u8_round(x: torch.Tensor) -> torch.Tensor:
    """clip(round(x), 0, 255) as uint8; torch.round rounds half to even, as
    jnp.round does."""
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def _abs_u8(x: torch.Tensor) -> torch.Tensor:
    """clip(|x|, 0, 255) truncated to uint8, as astype truncates."""
    return torch.clamp(x.abs(), 0, 255).to(torch.uint8)


def detect_colors(image_bgr, boundaries=None, device: str | torch.device = "cuda"):
    """`detect_color.py:19-26`: per band, the inRange mask and the masked
    image, tensors on `device`."""
    img = on_device(image_bgr, device)
    outs = []
    for lower, upper in boundaries or COLOR_BOUNDARIES:
        mask = in_range(img, lower, upper)
        outs.append((mask, bitwise_and_mask(img, mask)))
    return outs


def skin_mask(frame_bgr, device: str | torch.device = "cuda") -> torch.Tensor:
    """`skindetector.py:10-33`: HSV inRange([0,48,80],[20,255,255]) →
    ellipse-kernel erode×2 / dilate×2 → Gaussian blur → masked frame."""
    frame = on_device(frame_bgr, device)
    mask = in_range(bgr2hsv(frame), (0, 48, 80), (20, 255, 255))
    k = structuring_element("ellipse", (11, 11))
    mask = dilate(erode(mask, k, iterations=2), k, iterations=2)
    mask = _u8_round(gaussian_blur(mask.to(torch.float32), 3, 0.0))
    return bitwise_and_mask(frame, mask)


def brightest_spot(image_bgr, radius: int = 0, device: str | torch.device = "cuda") -> tuple[tuple[int, int], torch.Tensor]:
    """`bright.py:12-21`: the (x, y) of the grayscale image's maximum (the
    first one in row-major order, as argmax returns it), naive or, with
    radius > 0, after a Gaussian blur; and the gray image it searched."""
    gray = bgr2gray(on_device(image_bgr, device)).to(torch.float32)
    if radius > 0:
        gray = gaussian_blur(gray, radius, 0.0)
    y, x = divmod(int(torch.argmax(gray)), gray.shape[-1])
    return (x, y), gray


def locate_barcode(image_bgr, device: str | torch.device = "cuda") -> np.ndarray:
    """`detect_barcode.py:12-31`: Scharr gradient difference → 9×9 box
    blur → threshold 225 → close(21×7) → erode×4 / dilate×4 → the largest
    contour's rotated box (4×2 points)."""
    gray = bgr2gray(on_device(image_bgr, device)).to(torch.float32)
    gradient = _abs_u8(sobel(gray, 1, 0, ksize=-1) - sobel(gray, 0, 1, ksize=-1))
    box = np.full(9, 1 / 9)
    blurred = sep_filter_axis(sep_filter_axis(gradient.to(torch.float32), box, -2, "reflect101"), box, -1, "reflect101")
    thresh = threshold(_u8_round(blurred), 225, 255, "binary")
    closed = morphology_ex(thresh, "close", structuring_element("rect", (21, 7)))
    k3 = structuring_element("rect", (3, 3))
    closed = dilate(erode(closed, k3, iterations=4), k3, iterations=4)
    contours = find_external_contours(closed.cpu().numpy())
    if not contours:
        return np.zeros((0, 2))
    rect = min_area_rect(max(contours, key=contour_area))
    return np.intp(np.round(box_points(rect)))


def find_shapes(image_bgr, lower=(0, 0, 0), upper=(15, 15, 15), device: str | torch.device = "cuda"):
    """`find_shapes.py:11-17`: inRange shape mask → external contours."""
    mask = in_range(on_device(image_bgr, device), lower, upper)
    return find_external_contours(mask.cpu().numpy())
