"""LAB colour quantization (port of `opticalflowclustering_tpu/extras/quantize.py`;
the reference is `color-quantization/quant.py:15-26`).

The image's LAB pixels are clustered, then every pixel is repainted with its
cluster's rounded centre:

* ``method='minibatch'``: sklearn's MiniBatchKMeans semantics
  (cluster.kmeans.minibatch_kmeans) over every pixel;
* ``method='lloyd'`` (default): Lloyd k-means over a uniform
  without-replacement subsample of `sample` pixels, then every pixel is
  assigned to its nearest centre.
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.cluster.kmeans import (
    _default_generator,
    _pairwise_sqdist,
    kmeans,
    minibatch_kmeans,
)
from opticalflowclustering_tpu_torch.ops.lab import bgr2lab, lab2bgr


def _repaint(centers: torch.Tensor, labels: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Each pixel's rounded LAB centre, back to BGR: [H, W, 3] uint8."""
    quant = torch.clamp(torch.round(centers), 0, 255).to(torch.uint8)[labels]
    return lab2bgr(quant.reshape(hw + (3,)))


def quantize_colors(
    image_bgr: torch.Tensor,
    n_clusters: int,
    generator: torch.Generator | None = None,
    sample: int = 4096,
    method: str = "lloyd",
) -> torch.Tensor:
    """[H, W, 3] uint8 → quantized [H, W, 3] uint8 of `n_clusters` LAB
    colours, on the image's device. `sample` bounds the clustering subsample
    of method='lloyd' only. Draws come from `generator` (default: seed 0)."""
    img = torch.as_tensor(image_bgr)
    h, w = img.shape[-3], img.shape[-2]
    lab = bgr2lab(img).reshape(-1, 3).to(torch.float32)
    gen = _default_generator(generator)
    n = lab.shape[0]
    if method == "minibatch":
        centers, labels = minibatch_kmeans(lab, n_clusters, gen)
    elif method == "lloyd":
        idx = torch.randperm(n, generator=gen)[: min(sample, n)].to(lab.device)
        centers, _ = kmeans(lab[idx], n_clusters, gen)
        labels = torch.argmin(_pairwise_sqdist(lab, centers), dim=-1)
    else:
        raise ValueError(f"unknown method {method!r}")
    return _repaint(centers, labels, (h, w))
