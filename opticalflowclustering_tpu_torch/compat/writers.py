"""Byte-compatible CSV writers (port of `opticalflowclustering_tpu/compat/writers.py`).

The reference's downstream consumers read its CSV artifacts, so the bytes
are those the JAX package's writers produce. Those use pandas; these use
the `csv` module and Python's shortest float repr, which is what pandas
writes for float64 columns, so the port needs no pandas.

- `OutCSV/<video>.csv`: header `cell_0..cell_N-1`, integer hue rows.
- `cluster_centers.csv` / `addnew.csv`: rows
  `name,[ 12.  34.  56.   0.],[[[h s v]]],hue` (stringified numpy arrays).
- `<video>_rgb_values.csv`: the same header, float hue strings ("12.0").
- `<video>_opticalFlow.csv`: pandas default-index frame / mean-magnitude rows.
"""

from __future__ import annotations

import csv
import math
import os

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.colorspace import bgr2hsv


def write_hue_table_csv(path: str, hue_table: np.ndarray) -> None:
    """OutCSV contract: [frames, cells] integer hues under a cell_i header."""
    hue_table = np.asarray(hue_table).astype(np.int64)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([f"cell_{i}" for i in range(hue_table.shape[1])])
        w.writerows(row.tolist() for row in hue_table)


def write_rgb_values_csv(path: str, hue_table: np.ndarray) -> None:
    """`*_rgb_values.csv` contract (`drawGridsAndOutputCSVChange.py:135-141`):
    [frames, cells] hues as float64 strings ("12.0") under a cell_i header,
    as pandas writes a float64 frame; NaN is written empty."""
    hue_table = np.asarray(hue_table, dtype=np.float64)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([f"cell_{i}" for i in range(hue_table.shape[1])])
        for row in hue_table.tolist():
            w.writerow(["" if math.isnan(v) else repr(v) for v in row])


def append_cluster_centers_rows(
    path: str,
    names: list[str],
    centroids: np.ndarray,
    hues: np.ndarray,
    header: bool = False,
) -> None:
    """cluster_centers.csv / addnew.csv contract: one appended row per image,
    `name, str(rint(centroid_rgba)), str(hsv_1x1x3), hue`
    (`color_kmeans.py:105-133`). header=True writes the header when the
    target is new or empty."""
    centroids = np.asarray(centroids)
    hues = np.asarray(hues)
    fresh = not os.path.exists(path) or os.stat(path).st_size == 0
    with open(path, "a", newline="") as f:
        w = csv.writer(f)
        if header and fresh:
            w.writerow(["File name", "Cluster 1", "HSV Cluster 1", "Hue 0"])
        cen_f = centroids.astype(np.float64).reshape(len(centroids), -1)
        # Each row's [[[h s v]]]: the truncated BGR centroid as a 1×1 image,
        # converted for all rows in one call.
        hsv = _hsv_1x1(cen_f[:, :3].astype(np.int64).astype(np.uint8))
        for name, cen, hsv_arr, hue in zip(names, cen_f, hsv, hues):
            w.writerow([name, str(cen), str(hsv_arr), int(hue)])


def _hsv_1x1(bgr: np.ndarray) -> np.ndarray:
    """[N, 3] uint8 BGR → the [N, 1, 1, 3] uint8 HSV arrays the reference
    stringifies, one [[[h s v]]] per row."""
    return bgr2hsv(torch.from_numpy(bgr.reshape(-1, 1, 1, 3))).numpy()


def write_optical_flow_csv(path: str, mean_magnitudes: np.ndarray) -> None:
    """`<input>_opticalFlow.csv`: the bytes of pandas' `DataFrame.to_csv`
    with the default index and columns Frame / Average Magnitude
    (`computeOpticalFlow.py:146-149`); NaN is written empty, as pandas does."""
    mags = np.asarray(mean_magnitudes, dtype=np.float64)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["", "Frame", "Average Magnitude"])
        for i, m in enumerate(mags.tolist()):
            w.writerow([i, i, "" if math.isnan(m) else repr(m)])
