"""Host image-tree readers for the reference's filesystem layouts (port of
`opticalflowclustering_tpu/io/images.py`). cv2 is imported inside the
readers."""

from __future__ import annotations

import os
import re

import numpy as np

_NUM = re.compile(r"(\d+)")


def numeric_key(name: str):
    """First-integer sort key, matching `get_number` (`KmeanGrids.py:341-347`;
    the reference sorts frame folders and cell files numerically)."""
    m = _NUM.search(name)
    return int(m.group(1)) if m else -1


def read_png_dir(path: str, max_frames: int | None = None) -> np.ndarray:
    """Read a directory of same-size images (numeric order) → [N,H,W,3] BGR."""
    import cv2

    names = sorted(
        (n for n in os.listdir(path) if n.lower().endswith((".png", ".jpg"))),
        key=numeric_key,
    )
    if max_frames is not None:
        names = names[:max_frames]
    return np.stack([cv2.imread(os.path.join(path, n)) for n in names])


def read_cell_tree(path: str, max_frames: int | None = None) -> np.ndarray:
    """Read an OutImgs/<video>/ tree (`<frame>/<cell>.png`, frames and cells
    numerically sorted like `KmeanGrids.py:376-385`) →
    [frames, cells, ys, xs, 3] uint8 BGR."""
    import cv2

    frame_dirs = sorted(
        (d for d in os.listdir(path) if os.path.isdir(os.path.join(path, d))),
        key=numeric_key,
    )
    if max_frames is not None:
        frame_dirs = frame_dirs[:max_frames]
    out = []
    for fd in frame_dirs:
        fdir = os.path.join(path, fd)
        cells = sorted((n for n in os.listdir(fdir) if n.endswith(".png")), key=numeric_key)
        out.append(np.stack([cv2.imread(os.path.join(fdir, c)) for c in cells]))
    return np.stack(out)
