"""Content-based image retrieval (port of
`opticalflowclustering_tpu/extras/search_engine.py`; the reference is
`FirstImageSearchEngine/` and its `hobbit-lotr-image-search-engine/`
duplicate).

- `RGBHistogram.describe` (`rgbhistogram.py:8-13`): 3-D RGB histogram,
  L2-normalized, flattened.
- `Searcher.search` (`searcher.py:7-16`): chi²-distance ranking, one
  [N, D] against [1, D] broadcast rather than a loop over the index.
- `index_images` (`indexdataset.py:14-26`): every image's histogram in one
  batched call on the device (saved as .npz rather than cPickle).
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.histogram import (
    chi2_distance,
    rgb_histogram_feature,
    rgb_histogram_features,
)
from opticalflowclustering_tpu_torch.runtime import on_device


class RGBHistogram:
    """API-compatible descriptor (`rgbhistogram.py:4-13`), on `device`."""

    def __init__(self, bins=(8, 8, 8), device: str | torch.device = "cuda"):
        self.bins = tuple(bins)
        self.device = device

    def describe(self, image) -> np.ndarray:
        return rgb_histogram_feature(on_device(image, self.device), self.bins).cpu().numpy()


def index_images(images: np.ndarray, bins=(8, 8, 8), device: str | torch.device = "cuda") -> np.ndarray:
    """[N, H, W, 3] uint8 → [N, prod(bins)] features in one batched call."""
    return rgb_histogram_features(on_device(images, device), bins).cpu().numpy()


class Searcher:
    """`searcher.py:4-21` with a vectorized chi² ranking on `device`."""

    def __init__(self, index: dict[str, np.ndarray], device: str | torch.device = "cuda"):
        self.index = index
        self.device = device
        self._names = list(index.keys())
        self._feats = on_device(np.stack([index[k] for k in self._names]), device)

    def search(self, query_features) -> list[tuple[float, str]]:
        q = on_device(np.asarray(query_features, np.float32), self.device)
        d = chi2_distance(self._feats, q[None, :]).cpu().numpy()
        return sorted((float(dist), name) for name, dist in zip(self._names, d))

    @staticmethod
    def chi2_distance(a, b, eps=1e-10, device: str | torch.device = "cuda") -> float:
        return float(chi2_distance(on_device(a, device), on_device(b, device), eps))
