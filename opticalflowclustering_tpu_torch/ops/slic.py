"""SLIC superpixels (port of `opticalflowclustering_tpu/ops/slic.py`; the
reference is `SLIC-Superpixel/slic.py:14-15`, skimage `slic(image,
n_segments, sigma)` + `mark_boundaries`).

Localized k-means in LABXY space (Achanta et al. 2012): cluster centres
start on a grid; each pixel considers only the 3×3 neighbourhood of grid
clusters around its cell (the 2S-window rule), so the assignment is a
static 9-way gather and argmin, and the centre update is one float32
one-hot matmul, as in the JAX function (an `index_add_` would sum in
another order, and on the card in no fixed order). Its LAB input inherits
`ops.lab`'s last-code differences from eager JAX, so labels can differ
from the JAX function's at near-ties.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import gaussian_blur
from opticalflowclustering_tpu_torch.ops.lab import bgr2lab
from opticalflowclustering_tpu_torch.runtime import f32


def slic(
    image_bgr: torch.Tensor,
    n_segments: int = 100,
    compactness: float = 10.0,
    n_iter: int = 10,
    sigma: float = 5.0,
) -> torch.Tensor:
    """[H,W,3] uint8 BGR → [H,W] int32 superpixel labels on its device.

    skimage-equivalent parameters: n_segments (approximate), compactness
    (space/colour trade-off), sigma (pre-smoothing). Labels index the
    (gy×gx) cluster grid actually allocated."""
    dev = image_bgr.device
    h, w = image_bgr.shape[0], image_bgr.shape[1]
    lab = bgr2lab(image_bgr).to(torch.float32)
    if sigma > 0:
        ks = int(2 * round(3 * sigma) + 1)
        lab = gaussian_blur(lab, ks, sigma, axes=(-3, -2))

    step = math.sqrt(h * w / n_segments)
    gy = max(int(round(h / step)), 1)
    gx = max(int(round(w / step)), 1)
    k = gy * gx
    sy, sx = h / gy, w / gx

    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    feats = torch.cat([lab, xs[..., None], ys[..., None]], dim=-1)  # [H, W, 5] = (L, a, b, x, y)

    # Initial centres at the grid cells' midpoints.
    cy0, cx0 = np.meshgrid((np.arange(gy) + 0.5) * sy, (np.arange(gx) + 0.5) * sx, indexing="ij")
    init_xy = np.stack([cx0.ravel(), cy0.ravel()], axis=-1).astype(np.float32)
    cyi = torch.from_numpy(np.clip(init_xy[:, 1].astype(np.int32), 0, h - 1)).to(dev)
    cxi = torch.from_numpy(np.clip(init_xy[:, 0].astype(np.int32), 0, w - 1)).to(dev)
    centers = feats[cyi, cxi]  # [K, 5]

    # Each pixel's 9 candidate clusters: the 3×3 neighbourhood of its cell.
    cell_y = np.clip((np.arange(h) / sy).astype(np.int64), 0, gy - 1)
    cell_x = np.clip((np.arange(w) / sx).astype(np.int64), 0, gx - 1)
    cand = np.empty((h, w, 9), np.int64)
    i = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            cand[:, :, i] = np.clip(cell_y[:, None] + dy, 0, gy - 1) * gx + np.clip(cell_x[None, :] + dx, 0, gx - 1)
            i += 1
    cand = torch.from_numpy(cand).to(dev)

    # SLIC distance: d² = d_lab² + (compactness/step)²·d_xy², summed over
    # the 5 features in order.
    ratio = f32((compactness / step) ** 2)
    weights = (1.0, 1.0, 1.0, ratio, ratio)
    flat = feats.reshape(-1, 5)

    def assign(centers):
        d = feats[:, :, None, :] - centers[cand]  # [H, W, 9, 5]
        d2 = d[..., 0] * d[..., 0] * weights[0]
        for f in range(1, 5):
            d2 = d2 + d[..., f] * d[..., f] * weights[f]
        best = torch.argmin(d2, dim=-1)
        return torch.gather(cand, -1, best[..., None])[..., 0]

    for _ in range(n_iter):
        onehot = torch.zeros((h * w, k), dtype=torch.float32, device=dev)
        onehot.scatter_(1, assign(centers).reshape(-1, 1), 1.0)
        counts = onehot.sum(dim=0)
        centers = (onehot.T @ flat) / torch.clamp_min(counts[:, None], 1.0)
    return assign(centers).to(torch.int32)


def mark_boundaries(image_bgr: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """skimage mark_boundaries-style overlay: pixels at a label change
    (against the left or upper neighbour) painted yellow, the rest the
    image, as float32 in [0, 1] like skimage."""
    h, w = labels.shape
    diff = torch.zeros((h, w), dtype=torch.bool, device=labels.device)
    diff[:, 1:] = labels[:, 1:] != labels[:, :-1]
    diff[1:, :] |= labels[1:, :] != labels[:-1, :]
    img = image_bgr.to(torch.float32) / 255.0
    color = torch.tensor([0.0, 1.0, 1.0], dtype=torch.float32, device=img.device)  # BGR yellow
    return torch.where(diff[..., None], color, img)
