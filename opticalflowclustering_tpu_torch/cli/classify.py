"""Image-classification CLI on PyTorch (port of `opticalflowclustering_tpu/
cli/classify.py`, mirroring the cv2.dnn GoogLeNet demo
`deep-learning-with-opencv/deep_learning_with_opencv.py`): load an image,
run one forward pass of the committed FlowCellNet, print the inference time
and the top-k labels in the demo's format.

  -i image.png [-k 2] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-i", "--image", required=True)
    ap.add_argument("-k", "--topk", type=int, default=2)
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to run on (default cuda; it raises where there is "
        "no CUDA device rather than running on the CPU)",
    )
    args = ap.parse_args(argv)

    import cv2
    import numpy as np

    from opticalflowclustering_tpu_torch.models.flow_cnn import classify_cells, load_params, top_k_labels

    image = cv2.imread(args.image)
    if image is None:
        raise SystemExit(f"cannot read {args.image}")
    if image.shape[:2] != (50, 50):
        image = cv2.resize(image, (50, 50), interpolation=cv2.INTER_LINEAR)

    model = load_params(device=args.device)
    classify_cells(model, image[None])  # warm up outside the timing
    start = time.time()
    probs = classify_cells(model, image[None])[0]
    end = time.time()
    # `deep_learning_with_opencv.py:25` timing line, `:29-33` top-k lines
    print(f"[INFO] classification took {end - start:.5f} seconds")
    for rank, label, p in top_k_labels(probs, args.topk):
        print(f"[INFO] {rank}. label: {label}, probability: {p:.5f}")
    return np.argmax(probs)


if __name__ == "__main__":
    main()
