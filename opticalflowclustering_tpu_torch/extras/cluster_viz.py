"""Cluster visualization helpers (port of
`opticalflowclustering_tpu/extras/cluster_viz.py`; the reference is
`k-means-color-clustering/utils.py:5-23`): label-frequency histogram and the
horizontal colour-bar image. numpy only: nothing here runs on a device."""

from __future__ import annotations

import numpy as np


def centroid_histogram(labels: np.ndarray) -> np.ndarray:
    """`utils.py centroid_histogram:5-10`: normalized label frequencies."""
    labels = np.asarray(labels)
    k = len(np.unique(labels))
    hist, _ = np.histogram(labels, bins=np.arange(0, k + 1))
    hist = hist.astype("float")
    return hist / hist.sum() if hist.sum() else hist


def plot_colors(hist: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """`utils.py plot_colors:13-23`: 50×300 bar with each centroid's colour
    spanning its percentage of the width."""
    bar = np.zeros((50, 300, 3), dtype=np.uint8)
    start_x = 0.0
    for percent, color in zip(hist, centroids):
        end_x = start_x + percent * 300
        bar[:, int(start_x) : int(end_x)] = np.clip(np.asarray(color)[:3], 0, 255).astype(np.uint8)
        start_x = end_x
    return bar
