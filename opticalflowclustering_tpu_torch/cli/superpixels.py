"""SLIC CLI on PyTorch (port of `opticalflowclustering_tpu/cli/superpixels.py`;
the reference is `SLIC-Superpixel/slic.py`): segment the image on
`--device` at 100/200/300 segments and write each boundary overlay.

  -i image.jpg [-o out_prefix] [--segments N ...] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-o", "--out", default="superpixels")
    ap.add_argument("--segments", type=int, nargs="+", default=[100, 200, 300])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; it raises where there is no CUDA "
                    "device rather than running on the CPU)")
    args = ap.parse_args(argv)

    import cv2
    import numpy as np
    import torch

    from opticalflowclustering_tpu_torch.ops.slic import mark_boundaries, slic
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    img = torch.from_numpy(cv2.imread(args.image)).to(dev)
    for n in args.segments:
        labels = slic(img, n_segments=n, sigma=5.0)
        overlay = mark_boundaries(img, labels).cpu().numpy()
        path = f"{args.out}_{n}.png"
        cv2.imwrite(path, (overlay * 255).astype(np.uint8))
        print(f"{path}: {len(torch.unique(labels))} segments")


if __name__ == "__main__":
    main()
