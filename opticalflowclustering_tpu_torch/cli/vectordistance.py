"""Whole-matrix vector distance CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/vectordistance.py`, mirroring
`computeVectorDistance.py` / `exampleVectorDistances.py`):

  file1.csv file2.csv [--device cuda|cpu]

Prints the cosine similarity of the two hue CSVs' values (every column but
the first, flattened, over the common prefix of rows) and the summed per-row
Euclidean distance over the common prefix, with the reference's warning when
the lengths differ.
"""

from __future__ import annotations

import argparse
import csv

import numpy as np


def load(path: str) -> np.ndarray:
    """Every column but the first of each row of a headerless CSV, as
    float64 rows."""
    with open(path) as f:
        return np.asarray([[float(v) for v in row[1:]] for row in csv.reader(f)], dtype=float)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("file1", nargs="?", default="file1.csv")
    ap.add_argument("file2", nargs="?", default="file2.csv")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import torch

    from opticalflowclustering_tpu_torch.cluster.matcher import (
        cosine_similarity_matrix,
        rowwise_euclidean_sum,
    )
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    hsv1, hsv2 = load(args.file1), load(args.file2)
    m = min(len(hsv1), len(hsv2))
    a, b = torch.from_numpy(hsv1).to(dev), torch.from_numpy(hsv2).to(dev)
    sim = np.float32(cosine_similarity_matrix(a[:m].reshape(1, -1), b[:m].reshape(1, -1))[0, 0].item())
    dist = float(rowwise_euclidean_sum(a, b))

    if len(hsv1) != len(hsv2):
        print(
            "Warning: The vectors have different lengths, only the Euclidean "
            "distance of the common subvectors has been computed."
        )
    print("Cosine similarity:", sim)
    print("Euclidean distance:", dist)


if __name__ == "__main__":
    main()
