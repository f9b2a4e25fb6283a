"""Fused flow→grid→cluster CLI on PyTorch (port of
`opticalflowclustering_tpu/cli/kmeangrids.py`, mirroring
`k-means-color-clustering/KmeanGrids.py`, usage `KmeanGrids.py:406`):

  -d OutImgs/<video> -c 1 -f addnew.csv --noyolo --nocontour --path <video>
  [--device cuda|cpu] [--warp-mode fast|fast16|exact|select] [--stream]

Writes `OutCSV/<video>.csv` (hue table) and appends the per-cell rows to the
-f CSV in the addnew.csv format. With a video at `--path` it runs flow, grid
and clustering on the device, decoded at once or, with `--stream`, chunk by
chunk on a thread that overlaps the card (`pipeline.bounce.
process_video_stream`; the same tables). When `--path` is no file, or is a
Git-LFS pointer stub (as every .mp4 of the reference tree is), it clusters
the OutImgs cell tree at `-d` instead (the reference's phase-2-only run:
`io.images.read_cell_tree` → `preprocess_cells_rgba` → `dominant_hue_k1`),
as the JAX CLI does.

The overlay flags are argparse `store_false`, as the reference's: without
--noyolo the YOLO boxes of `yolo_labels.txt` (in the working directory),
and without --nocontour the polygons under `Contours/<video file name>/`,
are drawn onto each rendered flow frame on the device before the grid stage
(`pipeline.bounce.process_frames(..., overlays=OverlaySpec(...))`). The
stream is feature-only and refuses overlays.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_arguments(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-d", "--dir", required=True, help="Path to the image")
    ap.add_argument("-c", "--clusters", required=True, type=int)
    ap.add_argument("-f", "--csv", required=True, type=str)
    ap.add_argument("--noyolo", action="store_false")
    ap.add_argument("--nocontour", action="store_false")
    ap.add_argument("--path", required=True, help="Path to the input video")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--no-rb-swap",
        action="store_true",
        help="use the in-memory channel order instead of the golden-artifact "
        "disk-roundtrip order",
    )
    ap.add_argument(
        "--stream",
        action="store_true",
        help="decode-overlapped streaming pipeline (pipeline.bounce."
        "process_video_stream): background-thread decode, pinned-buffer "
        "copies overlapped with the card, constant host memory for long "
        "videos; the same tables (pass --noyolo --nocontour)",
    )
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
    return vars(ap.parse_args(argv))


def main(argv=None):
    args = parse_arguments(argv)
    rb_swap = not args["no_rb_swap"]

    from opticalflowclustering_tpu_torch.compat.writers import (
        append_cluster_centers_rows,
        write_hue_table_csv,
    )
    from opticalflowclustering_tpu_torch.io.video import is_lfs_pointer

    video_name = os.path.basename(args["dir"].rstrip("/\\"))
    use_video = os.path.isfile(args["path"])
    if use_video and is_lfs_pointer(args["path"]):
        # The reference commits every .mp4 as a Git-LFS pointer stub; fall
        # back to the committed OutImgs cell tree (phase-2-only) explicitly.
        print(f"{args['path']} is a Git-LFS pointer stub, not video data; "
              f"clustering the committed cell tree at {args['dir']} instead")
        use_video = False

    if use_video:
        from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
        from opticalflowclustering_tpu_torch.io.video import read_video_bgr
        from opticalflowclustering_tpu_torch.pipeline.bounce import (
            OverlaySpec,
            PipelineConfig,
            process_frames,
            process_video_stream,
        )

        # argparse store_false: the flags default True, and passing --noyolo /
        # --nocontour turns the overlays off (`KmeanGrids.py:255-257,353-354`).
        overlays = None
        if args["noyolo"] or args["nocontour"]:
            overlays = OverlaySpec(
                yolo_file="yolo_labels.txt" if args["noyolo"] else None,
                contour_dir="Contours" if args["nocontour"] else None,
                video_name=os.path.basename(args["path"]),
            )
        cfg = PipelineConfig(
            rb_swap=rb_swap,
            emit_flow_bgr=False,
            flow=FarnebackParams(warp_mode=args["warp_mode"]),
        )
        if args["stream"]:
            if overlays is not None:
                raise SystemExit("--stream is feature-only; pass --noyolo --nocontour")
            out = process_video_stream(args["path"], cfg, args["max_frames"], device=args["device"])
        else:
            frames = read_video_bgr(args["path"], args["max_frames"])
            out = process_frames(frames, cfg, args["device"], overlays=overlays)
        hue_table, centroids = out["hue_table"], out["centroids"]
    else:
        import torch

        from opticalflowclustering_tpu_torch.features.dominant_color import (
            dominant_hue_k1,
            preprocess_cells_rgba,
        )
        from opticalflowclustering_tpu_torch.io.images import read_cell_tree
        from opticalflowclustering_tpu_torch.runtime import resolve_device

        dev = resolve_device(args["device"])
        cells = torch.from_numpy(read_cell_tree(args["dir"], args["max_frames"])).to(dev)
        with torch.inference_mode():
            cen, hue = dominant_hue_k1(preprocess_cells_rgba(cells, rb_swap=rb_swap))
        hue_table, centroids = hue.cpu().numpy(), cen.cpu().numpy()

    os.makedirs("OutCSV", exist_ok=True)
    write_hue_table_csv(f"OutCSV/{video_name}.csv", hue_table)
    print(
        f"OutCSV/{video_name}.csv: {hue_table.shape[0]} frames x "
        f"{hue_table.shape[1]} cells"
    )

    names = [
        f"{f}/{c + 1}.png"
        for f in range(2, 2 + hue_table.shape[0])
        for c in range(hue_table.shape[1])
    ]
    append_cluster_centers_rows(
        args["csv"],
        names=names,
        centroids=np.asarray(centroids).reshape(-1, 4),
        hues=np.asarray(hue_table).reshape(-1),
    )


if __name__ == "__main__":
    main()
