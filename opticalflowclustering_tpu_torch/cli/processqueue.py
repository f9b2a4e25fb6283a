"""Multi-video fan-out CLI over the fault-tolerant queue on PyTorch (port of
`opticalflowclustering_tpu/cli/processqueue.py`): the serving entry point
that the reference drives with a shell loop over single-video runs
(`color_kmeans_script.sh:17-20`).

  python -m opticalflowclustering_tpu_torch.cli.processqueue v1.mp4 v2.avi ... \
      -o features/ [--dp 2 --sp 2] [--no-resume] [--warp-mode fast] [--device cuda]

Sequential by default (one device, retry and `.npz` resume). With `--dp`, a
dp×sp mesh runs the streaming data-parallel queue
(`pipeline.queue.process_video_queue_dp`): dp same-shape videos per batch,
frames split sp ways with a one-frame halo, decode overlapped behind the
batches, host buffering bounded. On `cuda` the mesh takes the first dp·sp
CUDA devices; on `cpu` it names the CPU dp·sp times. `--addnew FILE` also
appends the reference's per-cell rows (`KmeanGrids.py:320-339`) from each
finished video.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("videos", nargs="+", help="video files to process")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("--dp", type=int, default=0, help="data-parallel width (0 = sequential queue)")
    ap.add_argument("--sp", type=int, default=1, help="frame-axis shards per video (dp mode)")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--addnew", default=None, help="also append per-cell addnew rows to this CSV")
    ap.add_argument("--warp-mode", choices=("fast", "fast16", "exact"), default="fast")
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device type to run on (default cuda; it raises where there "
        "is no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import numpy as np

    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig
    from opticalflowclustering_tpu_torch.pipeline.queue import (
        load_features,
        process_video_queue,
        process_video_queue_dp,
    )
    from opticalflowclustering_tpu_torch.runtime import resolve_device

    cfg = PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode=args.warp_mode))
    resume = not args.no_resume
    dev = resolve_device(args.device)
    if args.dp > 0:
        from opticalflowclustering_tpu_torch.parallel.mesh import cuda_devices, make_mesh

        need = args.dp * args.sp
        devs = cuda_devices() if dev.type == "cuda" else [dev] * need
        if len(devs) < need:
            raise SystemExit(
                f"--dp {args.dp} --sp {args.sp} needs {need} devices; {len(devs)} available"
            )
        mesh = make_mesh({"dp": args.dp, "sp": args.sp}, devs[:need])
        results = process_video_queue_dp(
            args.videos, args.out_dir, mesh, cfg, resume=resume, max_frames=args.max_frames
        )
    else:
        results = process_video_queue(
            args.videos, args.out_dir, cfg, resume=resume, max_frames=args.max_frames, device=dev
        )

    ok = [r for r in results if r.ok]
    bad = [r for r in results if not r.ok]
    for r in ok:
        print(f"ok   {r.video} -> {r.path} (attempts={r.attempts})")
    for r in bad:
        print(f"FAIL {r.video}: {r.error}", file=sys.stderr)

    if args.addnew:
        from opticalflowclustering_tpu_torch.compat.writers import append_cluster_centers_rows

        for r in ok:
            t = load_features(r.path)
            hue = np.asarray(t["hue_table"])
            names = [
                f"{os.path.basename(r.video)}:{f}/{c + 1}.png"
                for f in range(2, 2 + hue.shape[0])
                for c in range(hue.shape[1])
            ]
            append_cluster_centers_rows(
                args.addnew,
                names=names,
                centroids=np.asarray(t["centroids"]).reshape(-1, 4),
                hues=hue.reshape(-1),
            )
        print(f"addnew rows appended to {args.addnew}")

    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
