"""Live-stream detection loop on PyTorch (port of `opticalflowclustering_tpu/
cli/realtime.py`, mirroring the real-time SSD demo `real-time-object-
detection-with-deep-learning-and-opencv/real_time_object_detection.py:29-71`):
a threaded VideoStream feeds frames, each frame is scored by the committed
FlowCellNet detector in one batched forward on the card, boxes are drawn,
and an FPS meter reports the elapsed time and the approximate throughput at
the end. Headless: annotated frames go to an MJPG video (`-o`), not to a
window.

  -s video.avi [-c 0.9] [--stride 25] [-o annotated.avi] [--max-frames N]
      [--device cuda|cpu]

`-s` also accepts a camera index (e.g. `-s 0`) where a camera exists.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-s", "--source", required=True, help="video path or camera index")
    ap.add_argument("-c", "--confidence", type=float, default=0.9)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    from opticalflowclustering_tpu_torch.cli.detect import draw_detections
    from opticalflowclustering_tpu_torch.io.video import VideoStream, write_video_mjpg
    from opticalflowclustering_tpu_torch.models.flow_cnn import detect_windows, load_params
    from opticalflowclustering_tpu_torch.utils.profiling import ThroughputMeter

    src = int(args.source) if args.source.isdigit() else args.source
    model = load_params(device=args.device)
    # Warm the detector up before the stream starts ticking, as the demo
    # loads its model before VideoStream(...).start().
    probe = cv2.VideoCapture(src)
    ok, first = probe.read()
    probe.release()
    if not ok:
        raise SystemExit(f"cannot read from {args.source}")
    detect_windows(model, np.zeros_like(first), stride=args.stride, confidence=args.confidence)
    vs = VideoStream(src).start()  # `real_time_object_detection.py:29`
    fps = ThroughputMeter().start()  # `:31`
    annotated = []
    n = 0
    try:
        while vs.running() or n == 0:
            frame = vs.read()
            if frame is None:
                break
            frame = frame.copy()
            dets = detect_windows(model, frame, stride=args.stride, confidence=args.confidence)
            draw_detections(frame, dets)
            if args.output:
                annotated.append(frame)
            fps.update()
            n += 1
            if args.max_frames is not None and n >= args.max_frames:
                break
    finally:
        vs.stop()
    # `real_time_object_detection.py:67-71`
    print(f"[INFO] elapsed time: {fps.elapsed():.2f}")
    print(f"[INFO] approx. FPS: {fps.fps():.2f}")
    if args.output and annotated:
        write_video_mjpg(args.output, np.stack(annotated), 30.0)
    return n


if __name__ == "__main__":
    main()
