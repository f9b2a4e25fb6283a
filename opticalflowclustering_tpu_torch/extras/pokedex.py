"""Pokédex shape retrieval (port of `opticalflowclustering_tpu/extras/pokedex.py`;
the reference is `Pokedex/`): a Zernike-moment index with a Euclidean
nearest-neighbour search, and the Game Boy screen finder.

- `ZernikeMoments.describe` (`pyimagesearch/zernikemoments.py:4-12`)
- indexing (`index.py:18-36`): threshold the sprite, keep the largest
  contour's filled outline, describe it
- `Searcher` (`searcher.py:4-16`): Euclidean ranking, vectorized (numpy)
- `find_screen` (`find_screen.py:16-74`): bilateral → Canny → 4-point quad
  → perspective rectification
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.extras.contours import (
    approx_poly_dp,
    arc_length,
    contour_area,
    fill_poly_mask,
    find_external_contours,
)
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.ops.edges import bilateral_filter, canny
from opticalflowclustering_tpu_torch.ops.moments import zernike_moments
from opticalflowclustering_tpu_torch.ops.warp import four_point_transform, resize_aspect
from opticalflowclustering_tpu_torch.runtime import on_device


class ZernikeMoments:
    """API-compatible descriptor (`zernikemoments.py:4-12`), on `device`."""

    def __init__(self, radius: float, device: str | torch.device = "cuda"):
        self.radius = radius
        self.device = device

    def describe(self, image, degree: int = 8) -> np.ndarray:
        return zernike_moments(on_device(image, self.device), self.radius, degree).cpu().numpy()


def sprite_outline(image_bgr, pad: int = 15, device: str | torch.device = "cuda") -> np.ndarray:
    """`index.py:18-30`: threshold mask (gray > 50), largest external
    contour, its filled outline raster (the shape the Zernike descriptor
    reads)."""
    gray = bgr2gray(on_device(image_bgr, device)).cpu().numpy()
    contours = find_external_contours((gray > 50).astype(np.uint8) * 255)
    if not contours:
        return np.zeros_like(gray)
    return fill_poly_mask(gray.shape, [max(contours, key=contour_area)], device).cpu().numpy()


class Searcher:
    """`Pokedex/searcher.py:4-16`: Euclidean ranking, vectorized."""

    def __init__(self, index: dict[str, np.ndarray]):
        self.index = index
        self._names = list(index.keys())
        self._feats = np.stack([index[k] for k in self._names])

    def search(self, query_features) -> list[tuple[float, str]]:
        q = np.asarray(query_features, np.float64)
        d = np.sqrt(((self._feats - q) ** 2).sum(axis=1))
        return sorted(zip(d.tolist(), self._names))


def find_screen(image_bgr, width: int = 300, device: str | torch.device = "cuda"):
    """`find_screen.py:16-74`: downscale, bilateral(11, 17, 17), Canny(30,
    200), the largest 4-point contour, rectify. Returns the warped screen
    (numpy) or None."""
    orig = on_device(image_bgr, device)
    ratio = orig.shape[1] / float(width)
    gray = bilateral_filter(bgr2gray(resize_aspect(orig, width=width)), 11, 17.0, 17.0)
    contours = find_external_contours(canny(gray, 30, 200).cpu().numpy())
    for c in sorted(contours, key=contour_area, reverse=True)[:10]:
        approx = approx_poly_dp(c, 0.015 * arc_length(c, closed=True), closed=True)
        if len(approx) == 4:
            return four_point_transform(orig, approx * ratio).cpu().numpy()
    return None
