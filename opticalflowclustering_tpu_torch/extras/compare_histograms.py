"""Histogram-distance survey (port of
`opticalflowclustering_tpu/extras/compare_histograms.py`; the reference is
`compare-histograms/comphis.py`, which never ran for its syntax errors):
normalized 3-D RGB histograms per image, compared with the four OpenCV
methods, three scipy-style distances and the hand-rolled chi², in float32
on `device`."""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.histogram import calc_hist, chi2_distance, compare_hist, normalize_l2
from opticalflowclustering_tpu_torch.runtime import on_device

OPENCV_METHODS = ("correl", "chisqr", "intersect", "bhattacharyya")
SCIPY_METHODS = ("euclidean", "cityblock", "chebyshev")


def describe(image_bgr, bins=(8, 8, 8), device: str | torch.device = "cuda") -> np.ndarray:
    h = calc_hist(on_device(image_bgr, device), [0, 1, 2], list(bins), [(0, 256)] * 3)
    return normalize_l2(h).cpu().numpy().ravel()


def scipy_distance(a, b, method: str, device: str | torch.device = "cuda") -> float:
    a = on_device(a, device).to(torch.float32)
    b = on_device(b, device).to(torch.float32)
    if method == "euclidean":
        return float(torch.sqrt(((a - b) ** 2).sum()))
    if method == "cityblock":
        return float((a - b).abs().sum())
    if method == "chebyshev":
        return float((a - b).abs().max())
    raise ValueError(method)


def compare_all(query_hist, index: dict[str, np.ndarray], device: str | torch.device = "cuda") -> dict[str, dict[str, float]]:
    """For each index image: every method's distance or similarity to the
    query histogram, the table comphis.py tried to display."""
    q = on_device(query_hist, device)
    out: dict[str, dict[str, float]] = {}
    for name, h in index.items():
        ht = on_device(h, device)
        row = {m: float(compare_hist(q, ht, m)) for m in OPENCV_METHODS}
        row.update({m: scipy_distance(q, ht, m, device) for m in SCIPY_METHODS})
        row["chi2_custom"] = float(chi2_distance(q, ht))
        out[name] = row
    return out
