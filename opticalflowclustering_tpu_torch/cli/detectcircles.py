"""Circle-detection CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/detectcircles.py`, mirroring the reference
demo `detect-circles/detect_circles.py:1-20`): load an image, run Hough
circles on `--device` at the demo's parameters (HOUGH_GRADIENT, dp=1.2,
minDist=75, param1=100, param2=100), draw each circle (green, thickness 4)
and the orange centre rectangle, and write the reference's side-by-side
[input | annotated] image.

  -i image [-o out.png] [--mode coherent|cv2-raw] [--device cuda|cpu]

`--mode coherent` (default) gates the radius support on the gradient
direction; `--mode cv2-raw` reproduces cv2.HoughCircles' raw semantics
(ops/hough.py). When the output buffer fills, a warning goes to stderr.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--image", required=True, help="Path to the image")
    ap.add_argument("-o", "--output", default=None,
                    help="annotated hstack output path (default <image>_circles.png)")
    ap.add_argument(
        "--mode",
        choices=("coherent", "cv2-raw"),
        default="coherent",
        help="'coherent' gates radius support on gradient direction (no "
        "accumulation-artifact circles); 'cv2-raw' matches cv2.HoughCircles' "
        "raw distance counting",
    )
    ap.add_argument("--dp", type=float, default=1.2)
    ap.add_argument("--min-dist", type=float, default=75.0)
    ap.add_argument("--param1", type=float, default=100.0)
    ap.add_argument("--param2", type=float, default=100.0)
    ap.add_argument("--max-circles", type=int, default=16,
                    help="size of the output buffer; raise it on circle-rich images (a warning is "
                    "printed to stderr when it fills)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; it raises where there is no CUDA "
                    "device rather than running on the CPU)")
    return ap


def main(argv: list[str] | None = None) -> int:
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.ops.hough import hough_circles
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    image = cv2.imread(args.image)
    if image is None:
        print(f"cannot read {args.image}")
        return 2
    output = image.copy()
    gray = torch.from_numpy(cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)).to(dev)
    circles = hough_circles(
        gray,
        dp=args.dp,
        min_dist=args.min_dist,
        canny_high=args.param1,
        acc_threshold=args.param2,
        max_circles=args.max_circles,
        coherence_gate=args.mode == "coherent",
    )
    if len(circles) == args.max_circles:
        print(f"warning: output buffer full ({args.max_circles}); more circles may exist — "
              f"re-run with a larger --max-circles", file=sys.stderr)
    for x, y, r in np.round(circles).astype(int):
        cv2.circle(output, (x, y), r, (0, 255, 0), 4)
        cv2.rectangle(output, (x - 5, y - 5), (x + 5, y + 5), (0, 128, 255), -1)
        print(f"circle x={x} y={y} r={r}")
    print(f"{len(circles)} circle(s) [{args.mode}]")
    out_path = args.output or (os.path.splitext(args.image)[0] + "_circles.png")
    cv2.imwrite(out_path, np.hstack([image, output]))
    print(f"wrote {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
