"""YOLO-box and contour overlays (port of `opticalflowclustering_tpu/io/overlays.py`;
the reference is `KmeanGrids.py:16-50`).

The reference can draw white YOLO bounding boxes (11-column label rows,
cols 3-6 = x, y, w, h) and mask segmented contours (white 2-px outline,
black fill) onto each flow frame before grid pooling. File parsing and the
per-frame row select stay on the host. The pixel edits take a numpy frame
or a tensor and edit it where it lies: on the card, the pipeline's overlay
path edits the rendered frames there, before the grid stage.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from opticalflowclustering_tpu_torch.extras.contours import fill_poly_mask
from opticalflowclustering_tpu_torch.ops.morphology import dilate, structuring_element


def load_yolo_boxes(path: str) -> np.ndarray:
    """`load_yolo_bounding_boxes:16-23`: whitespace table → rounded int
    rows reshaped to [-1, 11]."""
    data = np.loadtxt(path)
    return np.round(data).astype(np.int32).reshape(-1, 11)


def yolo_rects_for_frame(data: np.ndarray, frame_num: int) -> np.ndarray:
    """`KmeanGrids.py:203,26-31`: rows whose col 0 == frame, keeping cols
    3..6 as (x, y, w, h)."""
    return data[data[:, 0] == frame_num][:, 3:7]


def draw_rect_outline(frame, x: int, y: int, w: int, h: int, thickness: int = 2, color=(255, 255, 255)) -> None:
    """In-place rectangle outline on an [H, W, 3] uint8 frame (numpy or
    tensor), cv2.rectangle's thickness semantics: the line spans
    `thickness` pixels centred on the edge."""
    hh, ww = frame.shape[:2]
    lo = -(thickness // 2)
    hi = thickness - thickness // 2
    if isinstance(frame, torch.Tensor):
        col = torch.tensor(color, dtype=frame.dtype).to(frame.device)
    else:
        col = np.asarray(color, frame.dtype)
    for t in range(lo, hi):
        for (y0, y1, x0, x1) in (
            (y + t, y + t + 1, x, x + w + 1),  # top
            (y + h + t, y + h + t + 1, x, x + w + 1),  # bottom
            (y, y + h + 1, x + t, x + t + 1),  # left
            (y, y + h + 1, x + w + t, x + w + t + 1),  # right
        ):
            ys0, ys1 = max(y0, 0), min(y1, hh)
            xs0, xs1 = max(x0, 0), min(x1, ww)
            if ys0 < ys1 and xs0 < xs1:
                frame[ys0:ys1, xs0:xs1] = col


def load_contour_polys(contour_dir: str, video_name: str, frame_num: int):
    """`load_contours:34-50`: Contours/<video>/<video>_<frame>.txt, one
    polygon per line, first number dropped, the rest paired (x, y)."""
    path = os.path.join(contour_dir, video_name, f"{video_name}_{frame_num}.txt")
    if not os.path.isfile(path):
        return []
    polys = []
    with open(path) as f:
        for line in f:
            pts = np.fromstring(line, dtype=int, sep=" ")
            if pts.size <= 1:
                continue
            pts = pts[1:]
            pts = pts[: (pts.size // 2) * 2].reshape(-1, 2)
            if len(pts) > 0:
                polys.append(pts)
    return polys


def apply_contour_mask(frame, polys) -> None:
    """`load_contours:46-50`: white 2-px contour outline and black fill, in
    place on an [H, W, 3] uint8 frame (numpy, or a tensor on any device).
    The outline is the ring that a 5×5 dilation adds to the filled region."""
    if not polys:
        return
    on_device = isinstance(frame, torch.Tensor)
    fill = fill_poly_mask(frame.shape[:2], polys, frame.device if on_device else "cpu")
    ring = dilate(fill, structuring_element("rect", (5, 5))) > 0
    fill = fill > 0
    if not on_device:
        fill, ring = fill.numpy(), ring.numpy()
    frame[ring & ~fill] = 255
    frame[fill] = 0
