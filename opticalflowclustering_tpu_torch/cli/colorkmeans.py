"""Dominant-colour CLI on PyTorch (port of `opticalflowclustering_tpu/cli/
colorkmeans.py`, mirroring `k-means-color-clustering/color_kmeans.py`):

  (-i image | -d dir) -c clusters -f out.csv [--device cuda|cpu]

RGBA preprocess, the dominant colour (k=1: the exact integer mean; k>1: the
most-populated k-means cluster of each image, in one batched call), appended
CSV rows and a printed summary. Directory mode (`-d`) covers
`color_kmeansChange.py`'s tree walk.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("-i", "--image", help="Path to one image")
    g.add_argument("-d", "--dir", help="Directory of images (batched)")
    ap.add_argument("-c", "--clusters", required=True, type=int)
    ap.add_argument("-f", "--csv", required=True, type=str)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import cv2

    from opticalflowclustering_tpu_torch.compat.writers import append_cluster_centers_rows
    from opticalflowclustering_tpu_torch.io.images import numeric_key
    from opticalflowclustering_tpu_torch.pipeline.bounce import dominant_hue_series
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    if args.image:
        paths = [args.image]
    else:
        paths = [
            os.path.join(args.dir, n)
            for n in sorted(os.listdir(args.dir), key=numeric_key)
            if n.lower().endswith((".png", ".jpg"))
        ]

    frames = np.stack([cv2.imread(p) for p in paths])
    if args.clusters == 1:
        centroids, hues = dominant_hue_series(frames, rb_swap=True, device=dev)
        centroids, hues = centroids.cpu().numpy(), hues.cpu().numpy()
    else:
        from opticalflowclustering_tpu_torch.cluster.kmeans import kmeans_batched
        from opticalflowclustering_tpu_torch.features.dominant_color import preprocess_cells_rgba
        from opticalflowclustering_tpu_torch.ops.colorspace import bgr2hsv

        with torch.inference_mode():
            rgba = preprocess_cells_rgba(torch.from_numpy(frames).to(dev), rb_swap=True)
            pts = rgba.reshape(len(paths), -1, 4).to(torch.float32)
            centers, labels = kmeans_batched(pts, args.clusters)
            # dominant = most-populated cluster (color_kmeans.py:78-96)
            counts = torch.nn.functional.one_hot(labels, args.clusters).sum(dim=1)
            top = torch.argmax(counts, dim=-1)
            cen = centers[torch.arange(len(paths), device=dev), top]
        centroids = np.rint(cen.cpu().numpy())
        bgr = centroids[:, :3].astype(np.uint8).reshape(-1, 1, 1, 3)
        hues = bgr2hsv(torch.from_numpy(bgr)).numpy()[:, 0, 0, 0]

    # Row name: basename for the single-image entry (`color_kmeans.py:133`);
    # the directory variant writes the image PATH as traversed
    # (`color_kmeansChange.py:135`). Both write the header when the CSV is
    # new or empty (`color_kmeans.py:107-110`).
    names = [os.path.basename(p) for p in paths] if args.image else list(paths)
    append_cluster_centers_rows(args.csv, names, centroids, hues, header=True)
    for name, cen, hue in zip(names, centroids, hues):
        print(name, np.asarray(cen, np.float64), int(hue))


if __name__ == "__main__":
    main()
