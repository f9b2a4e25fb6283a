"""Flow-video and magnitude-telemetry CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/computeopticalflow.py`, mirroring
`k-means-color-clustering/computeOpticalFlow.py`):

  -i video [--max-frames N] [--warp-mode fast|fast16|exact|select] [--device cuda|cpu]

Writes `<input>onlyOpticalflow.mp4` (the rendered flow, MJPG),
`<input>_opticalFlow.csv` (mean |flow| per pair) and, where matplotlib is
importable, `<input>_squares.png` (its plot), and prints the reference's two
lines per pair.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(prog="OpticalFlow", description="find optical flow of video")
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--warp-mode",
        choices=("fast", "fast16", "exact", "select"),
        default="fast",
        help="flow-warp implementation: 'fast' runs the warp+M and box-solve "
        "CUDA kernels on the card; 'fast16' the same with R1 rounded through "
        "bf16; 'exact' the plain PyTorch warp; 'select' the legacy separable "
        "warp in plain PyTorch, INEXACT at motion discontinuities, kept for "
        "comparison only",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    from opticalflowclustering_tpu_torch.compat.writers import write_optical_flow_csv
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io.video import (
        read_video_bgr,
        video_fps,
        write_video_mjpg,
    )
    from opticalflowclustering_tpu_torch.pipeline.bounce import (
        PipelineConfig,
        process_frames,
    )

    frames = read_video_bgr(args.input, args.max_frames)
    out = process_frames(
        frames, PipelineConfig(flow=FarnebackParams(warp_mode=args.warp_mode)), args.device
    )

    write_video_mjpg(args.input + "onlyOpticalflow.mp4", out["flow_bgr"], video_fps(args.input))
    write_optical_flow_csv(args.input + "_opticalFlow.csv", out["mean_magnitude"])
    for i, m in enumerate(out["mean_magnitude"]):
        print("Average Magnitude of optical flow ", float(m))
        print("Number of VideoFrames processed", i + 1, "/", frames.shape[0])

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.plot(np.arange(len(out["mean_magnitude"])), out["mean_magnitude"], color="black")
        plt.savefig(args.input + "_squares.png")
    except ImportError:
        print("matplotlib unavailable; skipped _squares.png")


if __name__ == "__main__":
    main()
