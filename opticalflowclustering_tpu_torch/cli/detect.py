"""Object-detection CLI on PyTorch (port of `opticalflowclustering_tpu/cli/
detect.py`, mirroring the MobileNet-SSD demo `object-detection-with-deep-
learning-and-opencv/deep_learning_object_detection.py:12-38`): one image in,
confidence-filtered labeled boxes printed and drawn on an annotated copy.
Detection is the committed FlowCellNet over a strided window grid in one
batched forward, then the host NMS (models/flow_cnn.py).

  -i frame.png [-c 0.9] [--stride 25] [-o annotated.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse


def draw_detections(image, dets) -> None:
    """`deep_learning_object_detection.py:34-38`'s rectangle and label text
    for each detection, drawn on `image` in place."""
    import cv2

    for label, conf, (x1, y1, x2, y2) in dets:
        cv2.rectangle(image, (x1, y1), (x2, y2), (0, 0, 255), 2)
        y = y1 - 15 if y1 - 15 > 15 else y1 + 15
        cv2.putText(image, f"{label}: {conf * 100:.2f}%", (x1, y), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (0, 0, 255), 2)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-c", "--confidence", type=float, default=0.9)
    ap.add_argument("--stride", type=int, default=25)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import cv2

    from opticalflowclustering_tpu_torch.models.flow_cnn import detect_windows, load_params

    image = cv2.imread(args.image)
    if image is None:
        raise SystemExit(f"cannot read {args.image}")
    model = load_params(device=args.device)
    dets = detect_windows(model, image, stride=args.stride, confidence=args.confidence)
    for label, conf, _ in dets:
        print(f"[INFO] {label}: {conf * 100:.2f}%")
    draw_detections(image, dets)
    if args.output:
        cv2.imwrite(args.output, image)
    return dets


if __name__ == "__main__":
    main()
