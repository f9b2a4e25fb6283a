"""Contour utilities (port of `opticalflowclustering_tpu/extras/contours.py`).

Contour extraction and the shape metrics (`KmeanGrids.py:34-50`,
`DocumentScanner/scan.py:28-36`, `Pokedex/index.py:18-27`) follow data-
dependent, irregular paths and stay on the host in numpy; rasterizing
polygons into a mask (`fill_poly_mask`) runs on the device, so a mask
composites into frames that are already there.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import resolve_device

# Moore neighborhood in clockwise order starting from W.
_NBRS = [(-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1)]


def find_external_contours(mask: np.ndarray) -> list[np.ndarray]:
    """External contours of a binary mask (cv2.RETR_EXTERNAL-style), as
    [K, 2] arrays of (x, y) points via Moore border following."""
    m = (np.asarray(mask) > 0).astype(np.uint8)
    h, w = m.shape
    padded = np.zeros((h + 2, w + 2), np.uint8)
    padded[1:-1, 1:-1] = m
    visited = np.zeros_like(padded, bool)
    contours = []
    for y in range(1, h + 1):
        for x in range(1, w + 1):
            if padded[y, x] and not padded[y, x - 1] and not visited[y, x]:
                contour = _trace(padded, visited, y, x)
                contours.append(np.array([(p[1] - 1, p[0] - 1) for p in contour]))
    return contours


def _trace(img: np.ndarray, visited: np.ndarray, y0: int, x0: int):
    """Moore-neighbor tracing with Jacob's stopping criterion."""
    contour = [(y0, x0)]
    visited[y0, x0] = True
    prev_dir = 0  # index into _NBRS pointing W: the trace came from the left
    cy, cx = y0, x0
    for _ in range(img.size):
        for i in range(8):
            d = (prev_dir + 1 + i) % 8
            ny, nx = cy + _NBRS[d][0], cx + _NBRS[d][1]
            if img[ny, nx]:
                if (ny, nx) == (y0, x0) and len(contour) > 2:
                    return contour
                contour.append((ny, nx))
                visited[ny, nx] = True
                # The next search resumes clockwise from the backtrack
                # direction, the opposite of the move just made.
                prev_dir = (d + 4) % 8
                cy, cx = ny, nx
                break
        else:
            return contour  # isolated pixel
    return contour


def contour_area(contour: np.ndarray) -> float:
    """cv2.contourArea (shoelace, absolute)."""
    c = np.asarray(contour, np.float64)
    x, y = c[:, 0], c[:, 1]
    return float(abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2.0)


def arc_length(contour: np.ndarray, closed: bool = True) -> float:
    """cv2.arcLength."""
    c = np.asarray(contour, np.float64)
    d = np.diff(c, axis=0)
    total = float(np.hypot(d[:, 0], d[:, 1]).sum())
    if closed and len(c) > 1:
        total += float(np.hypot(*(c[0] - c[-1])))
    return total


def approx_poly_dp(contour: np.ndarray, epsilon: float, closed: bool = True):
    """Douglas-Peucker simplification (cv2.approxPolyDP semantics)."""
    pts = np.asarray(contour, np.float64)
    if len(pts) < 3:
        return pts.copy()
    if not closed:
        return _dp(pts, epsilon)
    # Split at the point farthest from the first, as OpenCV handles a
    # closed curve.
    far = int(np.argmax(np.linalg.norm(pts - pts[0], axis=1)))
    part1 = _dp(pts[: far + 1], epsilon)
    part2 = _dp(np.vstack([pts[far:], pts[:1]]), epsilon)
    return np.vstack([part1[:-1], part2[:-1]])


def _dp(pts: np.ndarray, eps: float) -> np.ndarray:
    if len(pts) < 3:
        return pts
    start, end = pts[0], pts[-1]
    seg = end - start
    seg_len = np.hypot(*seg)
    if seg_len == 0:
        dists = np.linalg.norm(pts - start, axis=1)
    else:
        rel = pts - start
        dists = np.abs(seg[0] * rel[:, 1] - seg[1] * rel[:, 0]) / seg_len
    i = int(np.argmax(dists))
    if dists[i] > eps:
        return np.vstack([_dp(pts[: i + 1], eps)[:-1], _dp(pts[i:], eps)])
    return np.vstack([start, end])


def bounding_rect(contour: np.ndarray) -> tuple[int, int, int, int]:
    """cv2.boundingRect: (x, y, w, h)."""
    c = np.asarray(contour)
    x, y = int(c[:, 0].min()), int(c[:, 1].min())
    return x, y, int(c[:, 0].max()) - x + 1, int(c[:, 1].max()) - y + 1


def convex_hull(points: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain convex hull, counter-clockwise."""
    pts = np.unique(np.asarray(points, np.float64), axis=0)
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) <= 2:
        return pts

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2:
                a = out[-1] - out[-2]
                b = p - out[-2]
                if a[0] * b[1] - a[1] * b[0] > 0:
                    break
                out.pop()
            out.append(p)
        return out

    return np.array(half(pts)[:-1] + half(pts[::-1])[:-1])


def min_area_rect(contour: np.ndarray):
    """cv2.minAreaRect via rotating calipers over the convex hull:
    ((cx, cy), (w, h), angle_deg)."""
    hull = convex_hull(contour)
    n = len(hull)
    if n == 1:
        return (tuple(hull[0]), (0.0, 0.0), 0.0)
    best = None
    for i in range(n):
        e = hull[(i + 1) % n] - hull[i]
        norm = np.hypot(*e)
        if norm == 0:
            continue
        ux, uy = e / norm
        rot = np.array([[ux, uy], [-uy, ux]])
        proj = hull @ rot.T
        mn, mx = proj.min(0), proj.max(0)
        area = (mx[0] - mn[0]) * (mx[1] - mn[1])
        if best is None or area < best[0]:
            cx, cy = (mn + mx) / 2 @ rot
            angle = np.degrees(np.arctan2(uy, ux))
            best = (area, (float(cx), float(cy)),
                    (float(mx[0] - mn[0]), float(mx[1] - mn[1])), float(angle))
    return best[1], best[2], best[3]


def box_points(rect) -> np.ndarray:
    """cv2.boxPoints."""
    (cx, cy), (w, h), angle = rect
    a = np.deg2rad(angle)
    ux, uy = np.cos(a), np.sin(a)
    ex = np.array([ux, uy]) * (w / 2)
    ey = np.array([-uy, ux]) * (h / 2)
    c = np.array([cx, cy])
    return np.array([c - ex - ey, c + ex - ey, c + ex + ey, c - ex + ey])


def fill_poly_mask(
    shape_hw: tuple[int, int], polygons, device: str | torch.device = "cuda"
) -> torch.Tensor:
    """fillPoly on `device`: even-odd crossing-number rasterization of
    polygons ([K,2] (x,y) vertex arrays) into an [H, W] uint8 {0,255} mask,
    the device half of the contour masking in `KmeanGrids.py:50`.

    Per polygon, the x where each non-horizontal edge crosses each row is
    one [E, H] float32 tensor, in the reference's float32 order
    `x1 + (y - y1) * (x2 - x1) / (y2 - y1)` with `x2 - x1` and `y2 - y1`
    taken in float32; rows an edge does not span get -inf. Sorted per row,
    `searchsorted` counts the crossings right of each pixel, so a polygon
    costs a fixed handful of launches whatever its vertex count."""
    dev = resolve_device(device)
    h, w = shape_hw
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    xs = torch.arange(w, dtype=torch.float32, device=dev).expand(h, w).contiguous()
    mask = torch.zeros((h, w), dtype=torch.bool, device=dev)
    for poly in polygons:
        p = np.asarray(poly, np.float32)
        q = np.roll(p, -1, axis=0)
        keep = p[:, 1] != q[:, 1]
        if not keep.any():
            continue
        (x1, y1), (x2, y2) = (torch.from_numpy(np.ascontiguousarray(a[keep].T)).to(dev) for a in (p, q))
        dx, dy = x2 - x1, y2 - y1  # float32, as the reference's numpy scalars
        xint = x1[:, None] + (ys[None, :] - y1[:, None]) * dx[:, None] / dy[:, None]
        spans = (ys[None, :] >= torch.minimum(y1, y2)[:, None]) & (ys[None, :] < torch.maximum(y1, y2)[:, None])
        xint = torch.where(spans, xint, -torch.inf).T.contiguous()
        right = xint.shape[1] - torch.searchsorted(xint.sort(dim=1).values, xs, right=True)
        mask |= right % 2 == 1
    return torch.where(mask, 255, 0).to(torch.uint8)
