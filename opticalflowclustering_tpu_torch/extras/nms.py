"""Non-maximum suppression (port of `opticalflowclustering_tpu/extras/nms.py`;
the reference is `non-max-suppression-slow/nms.py:3-33`).

The reference's O(n²) loop: boxes sorted by bottom-right y, overlap measured
against the *candidate's* area (`inter / area[j]`, not IoU), the last-sorted
box picked first. The host version is that loop in numpy; the device
version is the same selection rule as a masked fixed-trip loop on tensors.
"""

from __future__ import annotations

import numpy as np
import torch


def non_max_suppression(boxes: np.ndarray, overlap_thresh: float) -> np.ndarray:
    """Host version: the reference algorithm, [n, 4] boxes → the kept rows."""
    boxes = np.asarray(boxes)
    if len(boxes) == 0:
        return boxes[:0]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    idxs = np.argsort(y2)
    pick = []
    while len(idxs) > 0:
        i = idxs[-1]
        pick.append(i)
        xx1 = np.maximum(x1[i], x1[idxs[:-1]])
        yy1 = np.maximum(y1[i], y1[idxs[:-1]])
        xx2 = np.minimum(x2[i], x2[idxs[:-1]])
        yy2 = np.minimum(y2[i], y2[idxs[:-1]])
        w = np.maximum(0, xx2 - xx1 + 1)
        h = np.maximum(0, yy2 - yy1 + 1)
        overlap = (w * h).astype(float) / area[idxs[:-1]]
        idxs = idxs[:-1][overlap <= overlap_thresh]
    return boxes[pick]


def non_max_suppression_device(boxes: torch.Tensor, overlap_thresh: float) -> torch.Tensor:
    """Device version: [n, 4] boxes → a boolean keep-mask aligned with them,
    on the boxes' device. Each of n steps keeps the highest-priority box
    still alive (last in y2 order) and suppresses the boxes that overlap it
    by more than `overlap_thresh` of their own area; the [n, n] overlaps are
    computed once, in float32, and the loop does not wait for the device."""
    b = torch.as_tensor(boxes).to(torch.float32)
    n = b.shape[0]
    x1, y1, x2, y2 = b.unbind(-1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    w = torch.clamp(torch.minimum(x2[:, None], x2) - torch.maximum(x1[:, None], x1) + 1, min=0.0)
    h = torch.clamp(torch.minimum(y2[:, None], y2) - torch.maximum(y1[:, None], y1) + 1, min=0.0)
    ar = torch.arange(n, device=b.device)
    suppress = ((w * h) / area > overlap_thresh) | (ar[:, None] == ar)  # [picked, candidate]
    order = torch.argsort(y2, stable=True)
    alive = torch.ones(n, dtype=torch.bool, device=b.device)
    keep = torch.zeros(n, dtype=torch.bool, device=b.device)
    for _ in range(n):
        prio = torch.where(alive[order], ar, -1)
        i = order[torch.argmax(prio)]
        any_alive = alive.any()
        keep[i] = keep[i] | any_alive
        alive = torch.where(any_alive, alive & ~suppress[i], alive)
    return keep
