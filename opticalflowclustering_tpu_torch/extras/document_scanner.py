"""Document scanner (port of
`opticalflowclustering_tpu/extras/document_scanner.py`; the reference is
`DocumentScanner/scan.py:18-48`): edge detection → the largest 4-point
contour → perspective rectification → adaptive binarization. The image ops
run on `device`, the contour step on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.extras.contours import (
    approx_poly_dp,
    arc_length,
    contour_area,
    find_external_contours,
)
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.ops.edges import canny
from opticalflowclustering_tpu_torch.ops.filters import gaussian_blur
from opticalflowclustering_tpu_torch.ops.threshold import adaptive_threshold
from opticalflowclustering_tpu_torch.ops.warp import four_point_transform, resize_aspect
from opticalflowclustering_tpu_torch.runtime import on_device


def find_document_contour(image_bgr, device: str | torch.device = "cuda") -> np.ndarray | None:
    """scan.py:18-36: gray → GaussianBlur(5) → Canny(75, 200) → the largest
    contour whose 2%-of-arc-length approximation has 4 points."""
    gray = bgr2gray(on_device(image_bgr, device)).to(torch.float32)
    gray = torch.clamp(torch.round(gaussian_blur(gray, 5, 0.0)), 0, 255).to(torch.uint8)
    contours = find_external_contours(canny(gray, 75, 200).cpu().numpy())
    for c in sorted(contours, key=contour_area, reverse=True)[:5]:
        approx = approx_poly_dp(c, 0.02 * arc_length(c, closed=True), closed=True)
        if len(approx) == 4:
            return approx
    return None


def scan_document(image_bgr, height: int = 500, device: str | torch.device = "cuda"):
    """The whole scan.py flow: downscale for detection, rectify at the
    original resolution, adaptive threshold ('gaussian', block 251, offset
    10: the skimage threshold_adaptive call at scan.py:47). Returns
    (warped_bgr, binarized) numpy arrays, or (None, None) when no document
    quad is found."""
    orig = on_device(image_bgr, device)
    ratio = orig.shape[0] / float(height)
    small = resize_aspect(orig, height=height)
    quad = find_document_contour(small, device)
    if quad is None:
        return None, None
    warped = four_point_transform(orig, quad * ratio)
    binarized = adaptive_threshold(bgr2gray(warped), 255, method="gaussian", mode="binary", block_size=251, c=10)
    return warped.cpu().numpy(), binarized.cpu().numpy()
