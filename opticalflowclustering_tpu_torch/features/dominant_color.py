"""Per-cell dominant colour (port of `opticalflowclustering_tpu/features/dominant_color.py`).

Replicates `preprocess_image` + `cluster_colors` with k=1 (`KmeanGrids.py:
269-339`): dark pixels (<30) to zero, a binary alpha from grayscale, the
4-channel mean rounded half-to-even (KMeans with one cluster is the mean),
and the hue of the (b, g, r) centroid. `rb_swap=True` reproduces the R/B
swapped disk round trip that produced the golden OutCSV tables.
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.features.grid import (
    GridParams,
    grid_cell_sums,
    whiten_frame_lines,
)
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray, bgr2hsv


def preprocess_cells_rgba(cells: torch.Tensor, rb_swap: bool = True) -> torch.Tensor:
    """[..., ys, xs, 3] uint8 BGR → [..., ys, xs, 4] uint8: per-channel
    threshold (<30 → 0), alpha = 255 where the grayscale is nonzero."""
    if rb_swap:
        cells = cells.flip(-1)
    x = torch.where(cells < 30, torch.zeros_like(cells), cells)
    gray = bgr2gray(x)  # quirk: BGR weights on whatever order x is in
    alpha = torch.where(gray > 0, 255, 0).to(torch.uint8)
    return torch.cat([x, alpha[..., None]], dim=-1)


def _rint_div(p: torch.Tensor, q: int) -> torch.Tensor:
    """Exact round-half-to-even of the integer ratio p/q (np.rint of the
    KMeans centroid). PyTorch's integer // and % floor like jnp's."""
    m = p // q
    rem = p - m * q
    twice = 2 * rem
    roundup = (twice > q) | ((twice == q) & (m % 2 == 1))
    return m + roundup.to(p.dtype)


def dominant_hue_k1_frames(
    frames_bgr: torch.Tensor, grid: GridParams, rb_swap: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """dominant_hue_k1 of every grid cell, computed frame-wise (whiten with
    own rectangles, RGBA preprocess, per-cell sums).
    Returns (centroid [..., rows*cols, 4] int32, hue [..., rows*cols] uint8)."""
    h, w = frames_bgr.shape[-3], frames_bgr.shape[-2]
    ys, xs = grid.steps(h, w)
    wh = whiten_frame_lines(frames_bgr, grid, own_rectangle=True)
    s = grid_cell_sums(preprocess_cells_rgba(wh, rb_swap=rb_swap), grid)
    centroid = _rint_div(s, ys * xs)
    hue = bgr2hsv(centroid[..., :3].to(torch.uint8))[..., 0]
    return centroid, hue


def dominant_hue_k1(rgba_cells: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """k=1 `cluster_colors`: the centroid is the exact pixel mean.
    [..., ys, xs, 4] → (centroid [..., 4] int32, hue [...] uint8)."""
    s = rgba_cells.to(torch.int32).sum(dim=(-3, -2), dtype=torch.int32)
    count = rgba_cells.shape[-3] * rgba_cells.shape[-2]
    centroid = _rint_div(s, count)
    hue = bgr2hsv(centroid[..., :3].to(torch.uint8))[..., 0]
    return centroid, hue
