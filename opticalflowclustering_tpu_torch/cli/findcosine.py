"""Bounce-classification CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/findcosine.py`, mirroring
`k-means-color-clustering/findCosineDifferentVectors.py`):

  signature.csv series.csv [--device cuda|cpu]

Reads column 1 of each headerless CSV and prints the reference's four lines:
the vector sizes, the maximum cosine similarity of the signature against
every window of the series, the vestigial 'Minimum sum of squared
differences: 0', and the frame of the best window (the last tie wins).
"""

from __future__ import annotations

import argparse
import csv
import math

import numpy as np


def read_column(path: str, col: int = 1) -> np.ndarray:
    """Column `col` of a headerless numeric CSV as float64, an empty field as
    NaN: the values `pd.read_csv(path, header=None).iloc[:, col]` gives for
    the reference's hue-series files, without pandas."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    return np.array([float(r[col]) if r[col].strip() else math.nan for r in rows], np.float64)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("signature", help="CSV whose column 1 is the signature's hue series")
    ap.add_argument("series", help="CSV whose column 1 is the video's hue series")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu_torch.pipeline.bounce import classify_bounce

    file1_hue = read_column(args.signature)
    nobounce_hue = read_column(args.series)

    print("Vector sizes are: ", len(file1_hue), len(nobounce_hue))
    sim, frame = classify_bounce(file1_hue, nobounce_hue, device=args.device)
    print("Maximum cosine similarity:", sim)
    # The reference declares this value but never computes it (:50, :65).
    print("Minimum sum of squared differences:", 0)
    print("Max frame:", frame)


if __name__ == "__main__":
    main()
