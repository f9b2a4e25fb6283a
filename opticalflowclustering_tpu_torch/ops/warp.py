"""Geometric warps: warpAffine, warpPerspective, the perspective solve and
the four-point document rectification (port of
`opticalflowclustering_tpu/ops/warp.py`).

Reference call sites: `DocumentScanner/pyimagesearch/transform.py:5-64`
(order_points / four_point_transform), `imutils.py:5-58`
(translate/rotate/resize), `getperspectivetransform/transform.py`,
`Pokedex/find_screen.py:66-69`. The matrices are host float64 numpy; the
images are inverse-mapped bilinear samples on the tensor's device, in the
reference's float32 operation order.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import f32


def get_rotation_matrix_2d(center, angle_deg, scale) -> np.ndarray:
    """cv2.getRotationMatrix2D."""
    a = np.deg2rad(angle_deg)
    alpha, beta = scale * np.cos(a), scale * np.sin(a)
    cx, cy = center
    return np.array(
        [
            [alpha, beta, (1 - alpha) * cx - beta * cy],
            [-beta, alpha, beta * cx + (1 - alpha) * cy],
        ],
        dtype=np.float64,
    )


def get_perspective_transform(src_pts, dst_pts) -> np.ndarray:
    """cv2.getPerspectiveTransform: the 3×3 homography of 4 point pairs
    (an 8×8 linear solve, like OpenCV)."""
    src = np.asarray(src_pts, np.float64)
    dst = np.asarray(dst_pts, np.float64)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i] = u
        b[i + 4] = v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _sample_bilinear(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of [H, W, C] at float coordinates, constant-0 border
    (cv2 BORDER_CONSTANT default)."""
    h, w = img.shape[0], img.shape[1]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = (xs - x0)[..., None]
    fy = (ys - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def at(yy, xx):
        inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
        v = img[yy.clamp(0, h - 1), xx.clamp(0, w - 1)].to(torch.float32)
        return torch.where(inside[..., None], v, 0.0)

    return (
        at(y0i, x0i) * (1 - fx) * (1 - fy)
        + at(y0i, x0i + 1) * fx * (1 - fy)
        + at(y0i + 1, x0i) * (1 - fx) * fy
        + at(y0i + 1, x0i + 1) * fx * fy
    )


def _finish(out: torch.Tensor, dtype: torch.dtype, squeeze: bool) -> torch.Tensor:
    if dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    else:
        out = out.to(dtype)
    return out[..., 0] if squeeze else out


def _grid(w_out: int, h_out: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    gx = torch.arange(w_out, dtype=torch.float32, device=device)[None, :].expand(h_out, w_out)
    gy = torch.arange(h_out, dtype=torch.float32, device=device)[:, None].expand(h_out, w_out)
    return gx, gy


def _affine(m, gx, gy, row):
    return f32(m[row, 0]) * gx + f32(m[row, 1]) * gy + f32(m[row, 2])


def warp_affine(img: torch.Tensor, m: np.ndarray, dsize: tuple[int, int]) -> torch.Tensor:
    """cv2.warpAffine(img, M, (w, h)): inverse-mapped bilinear, constant
    border. img: [H, W] or [H, W, C]."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    minv = np.linalg.inv(np.vstack([np.asarray(m, np.float64), [0, 0, 1]]))[:2]
    gx, gy = _grid(*dsize, img.device)
    return _finish(_sample_bilinear(src, _affine(minv, gx, gy, 0), _affine(minv, gx, gy, 1)), img.dtype, squeeze)


def warp_perspective(img: torch.Tensor, m: np.ndarray, dsize: tuple[int, int]) -> torch.Tensor:
    """cv2.warpPerspective(img, M, (w, h))."""
    squeeze = img.ndim == 2
    src = img[..., None] if squeeze else img
    minv = np.linalg.inv(np.asarray(m, np.float64))
    gx, gy = _grid(*dsize, img.device)
    denom = _affine(minv, gx, gy, 2)
    xs = _affine(minv, gx, gy, 0) / denom
    ys = _affine(minv, gx, gy, 1) / denom
    return _finish(_sample_bilinear(src, xs, ys), img.dtype, squeeze)


def order_points(pts: np.ndarray) -> np.ndarray:
    """`transform.py order_points:5-26`: tl, tr, br, bl by coordinate
    sum/diff."""
    pts = np.asarray(pts, np.float32)
    rect = np.zeros((4, 2), np.float32)
    s = pts.sum(axis=1)
    rect[0] = pts[np.argmin(s)]
    rect[2] = pts[np.argmax(s)]
    d = np.diff(pts, axis=1)
    rect[1] = pts[np.argmin(d)]
    rect[3] = pts[np.argmax(d)]
    return rect


def four_point_transform(img: torch.Tensor, pts) -> torch.Tensor:
    """`transform.py four_point_transform:28-64`: rectify the quad to a
    top-down view sized by the longer of each pair of opposite edges."""
    rect = order_points(np.asarray(pts))
    tl, tr, br, bl = rect
    max_w = max(int(np.hypot(*(br - bl))), int(np.hypot(*(tr - tl))))
    max_h = max(int(np.hypot(*(tr - br))), int(np.hypot(*(tl - bl))))
    dst = np.array([[0, 0], [max_w - 1, 0], [max_w - 1, max_h - 1], [0, max_h - 1]], np.float32)
    return warp_perspective(img, get_perspective_transform(rect, dst), (max_w, max_h))


def translate(img: torch.Tensor, x: float, y: float) -> torch.Tensor:
    """imutils.translate (`pyimagesearch/imutils.py:5-11`)."""
    return warp_affine(img, np.float64([[1, 0, x], [0, 1, y]]), (img.shape[1], img.shape[0]))


def rotate(img: torch.Tensor, angle: float, center=None, scale: float = 1.0) -> torch.Tensor:
    """imutils.rotate (`imutils.py:13-27`)."""
    h, w = img.shape[:2]
    if center is None:
        center = (w // 2, h // 2)
    return warp_affine(img, get_rotation_matrix_2d(center, angle, scale), (w, h))


def resize_aspect(img: torch.Tensor, width=None, height=None) -> torch.Tensor:
    """imutils.resize (`imutils.py:29-58`): aspect-preserving bilinear."""
    from opticalflowclustering_tpu_torch.ops.resize import resize_linear_hwc

    h, w = img.shape[:2]
    if width is None and height is None:
        return img
    if width is None:
        dim = (height, int(w * (height / float(h))))
    else:
        dim = (int(h * (width / float(w))), width)
    squeeze = img.ndim == 2
    out = resize_linear_hwc(img[..., None] if squeeze else img, dim)
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out[..., 0] if squeeze else out
