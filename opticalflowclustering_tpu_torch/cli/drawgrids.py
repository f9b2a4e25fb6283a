"""Grid-overlay CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/drawgrids.py`, mirroring
`drawGridsAndOutputCSV[Change].py`):

  --path video [--noyolo --nocontour] [--optical flow.mp4 | --use-rgb]
  [--tenbyten] [--dump-cells] [--max-frames N] [--device cuda|cpu]

Writes `<video>_rgb_values.csv` (per-frame grid-mean hues of the flow
render computed on `--device`, of the frames of `--optical`, or of the RGB
frames with `--use-rgb`), `<video>_output.mp4` (those frames with the grid
lines and each cell's mean-BGR label), and with `--dump-cells` the
OutImgs/<video>/<frame>/<cell>.png tree that `kmeangrids` clusters.
`--tenbyten` takes the 10×10 grid of the non-Change variant
(`drawGridsAndOutputCSV.py:168`). The flow is computed in 'exact' mode, the
library default, as the JAX CLI does. --noyolo and --nocontour are
accepted and, as in the JAX CLI, change nothing: this CLI draws no overlays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def draw_grid(frames: np.ndarray, means: np.ndarray, grid) -> np.ndarray:
    """A copy of [N, H, W, 3] uint8 frames with the white grid lines and
    each cell's mean-BGR label (`means` [N, cells, 3]) centred in it, as the
    reference annotates (`drawGridsAndOutputCSV.py:106-122`:
    FONT_HERSHEY_SIMPLEX 0.3, white, thickness 1, LINE_AA)."""
    import cv2

    out = frames.copy()
    h, w = out.shape[1:3]
    ys, xs = grid.steps(h, w)
    for r in range(grid.rows + 1):
        out[:, min(r * ys, h - 1), : grid.cols * xs] = 255
    for c in range(grid.cols + 1):
        out[:, : grid.rows * ys, min(c * xs, w - 1)] = 255
    font, font_scale, thickness = cv2.FONT_HERSHEY_SIMPLEX, 0.3, 1
    for f in range(out.shape[0]):
        for i in range(grid.rows * grid.cols):
            x = (i % grid.cols) * xs
            y = (i // grid.cols) * ys + 10
            text = "({}, {}, {})".format(*(int(v) for v in means[f, i]))
            (tw, th), _ = cv2.getTextSize(text, font, font_scale, thickness)
            cv2.putText(out[f], text, (x + (xs - tw) // 2, y + (ys - th) // 2 + th), font,
                        font_scale, (255, 255, 255), thickness, cv2.LINE_AA)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", required=True)
    ap.add_argument(
        "--optical",
        default=None,
        help="pre-rendered flow video to grid instead of computing flow "
        "inline (the dual-VideoCapture variant, drawGridsAndOutputCSV.py:147-148)",
    )
    ap.add_argument(
        "--use-rgb",
        action="store_true",
        help="grid the RGB frames instead of the flow render (the showRGB "
        "toggle, drawGridsAndOutputCSV.py:180-183)",
    )
    ap.add_argument("--noyolo", action="store_false")
    ap.add_argument("--nocontour", action="store_false")
    ap.add_argument("--tenbyten", action="store_true")
    ap.add_argument("--dump-cells", action="store_true")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import cv2
    import torch

    from opticalflowclustering_tpu_torch.compat.writers import write_rgb_values_csv
    from opticalflowclustering_tpu_torch.features.grid import (
        GridParams,
        extract_cells,
        grid_mean_bgr,
        whiten_grid_lines,
    )
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import (
        PipelineConfig,
        grid_cluster_stage,
        process_frames,
    )
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    dev = resolve_device(args.device)
    grid = GridParams(10, 10) if args.tenbyten else GridParams(14, 25)
    cfg = PipelineConfig(grid=grid)
    frames = io_video.read_video_bgr(args.path, args.max_frames)

    if args.optical or args.use_rgb:
        # Grid pre-rendered flow frames (or the RGB frames themselves)
        # without computing flow: the non-Change variant's data flow.
        src = frames[1:] if args.use_rgb else io_video.read_video_bgr(args.optical, args.max_frames)
        _, hue, rgb_hue = grid_cluster_stage(src, grid, cfg.rb_swap, dev)
        out = {"flow_bgr": np.asarray(src), "hue_table": hue.cpu().numpy(),
               "rgb_hue_table": rgb_hue.cpu().numpy()}
    else:
        out = process_frames(frames, cfg, dev)

    write_rgb_values_csv(args.path + "_rgb_values.csv", out["rgb_hue_table"])

    flow = torch.from_numpy(out["flow_bgr"]).to(dev)
    # The label is each cell's mean taken before its own rectangle is drawn.
    means = grid_mean_bgr(flow, grid).cpu().numpy()
    io_video.write_video_mjpg(args.path + "_output.mp4", draw_grid(out["flow_bgr"], means, grid),
                              io_video.video_fps(args.path))

    if args.dump_cells:
        name = os.path.basename(args.path).split(".")[0]
        cells = whiten_grid_lines(extract_cells(flow, grid), grid, own_rectangle=True).cpu().numpy()
        for f in range(cells.shape[0]):
            d = f"OutImgs/{name}/{f + 2}"
            os.makedirs(d, exist_ok=True)
            for c in range(cells.shape[1]):
                cv2.imwrite(f"{d}/{c + 1}.png", cells[f, c])

    print(f"{args.path}_rgb_values.csv:", out["rgb_hue_table"].shape)


if __name__ == "__main__":
    main()
