"""cv2-exact bilinear resize (port of `opticalflowclustering_tpu/ops/resize.py`).

Integer-ratio downsamples and exact 2× upsamples (the whole Farneback pyramid
at 720p) are strided two-tap slices with one fixed multiply/add order, so
they are bitwise equal to the reference. Any other ratio is the banded
[dst, src] weight matrix applied with `torch.matmul` in full float32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_weight_matrix(dst_size: int, src_size: int) -> np.ndarray:
    """[dst, src] bilinear weights with OpenCV's coordinate convention:
    src_x = (dst_x + 0.5) * (src/dst) - 0.5, clamped at borders exactly the
    way OpenCV clamps (sx<0 → pixel 0 with weight 1; sx≥src-1 → last pixel
    with weight 1)."""
    scale = src_size / dst_size
    fx = (np.arange(dst_size, dtype=np.float64) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src_size - 1] = 0.0
    sx[sx >= src_size - 1] = src_size - 1
    w = np.zeros((dst_size, src_size), dtype=np.float32)
    w[np.arange(dst_size), sx] = (1.0 - fx).astype(np.float32)
    nz = fx > 0
    w[np.arange(dst_size)[nz], sx[nz] + 1] = fx[nz].astype(np.float32)
    return w


def _slice(x: torch.Tensor, axis: int, lo: int, hi: int, step: int = 1):
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(lo, hi, step)
    return x[tuple(sl)]


def _resize_axis_int_down(x: torch.Tensor, dst: int, axis: int) -> torch.Tensor:
    """Integer-factor downsample along `axis`: k = src/dst even → taps
    (0.5, 0.5) at k·j + k/2 − 1 and k·j + k/2; k odd → the single tap at
    k·j + (k−1)/2."""
    k = x.shape[axis] // dst
    if k % 2:
        start = (k - 1) // 2
        return _slice(x, axis, start, start + k * dst, k)
    a = _slice(x, axis, k // 2 - 1, k // 2 - 1 + k * dst, k)
    b = _slice(x, axis, k // 2, k // 2 + k * dst, k)
    return 0.5 * a + 0.5 * b


def _resize_axis_up2(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Exact-2× upsample along `axis`: interleaved (0.25, 0.75) taps, with
    OpenCV's border clamp on the first and last output rows."""
    n = x.shape[axis]
    up = torch.cat([_slice(x, axis, 0, 1), _slice(x, axis, 0, n - 1)], dim=axis)
    dn = torch.cat([_slice(x, axis, 1, n), _slice(x, axis, n - 1, n)], dim=axis)
    even = 0.25 * up + 0.75 * x
    odd = 0.75 * x + 0.25 * dn
    shp = list(x.shape)
    shp[axis] = 2 * n
    out = torch.stack([even, odd], dim=axis + 1).reshape(shp)
    first = [slice(None)] * x.ndim
    first[axis] = slice(0, 1)
    last = [slice(None)] * x.ndim
    last[axis] = slice(2 * n - 1, 2 * n)
    out[tuple(first)] = _slice(x, axis, 0, 1)
    out[tuple(last)] = _slice(x, axis, n - 1, n)
    return out


def resize_linear(img: torch.Tensor, dst_hw: tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) for [..., H, W]
    inputs (channels go in leading dims), computed in float32."""
    dst_h, dst_w = dst_hw
    src_h, src_w = img.shape[-2], img.shape[-1]
    x = img.to(torch.float32)
    if dst_h != src_h:
        ax = x.ndim - 2
        if src_h % dst_h == 0:
            x = _resize_axis_int_down(x, dst_h, ax)
        elif dst_h == 2 * src_h:
            x = _resize_axis_up2(x, ax)
        else:
            wy = torch.from_numpy(_linear_weight_matrix(dst_h, src_h)).to(x.device)
            x = torch.matmul(wy, x)
    if dst_w != src_w:
        ax = x.ndim - 1
        if src_w % dst_w == 0:
            x = _resize_axis_int_down(x, dst_w, ax)
        elif dst_w == 2 * src_w:
            x = _resize_axis_up2(x, ax)
        else:
            wx = torch.from_numpy(_linear_weight_matrix(dst_w, src_w)).to(x.device)
            x = torch.matmul(x, wx.T)
    return x


def resize_linear_hwc(img: torch.Tensor, dst_hw: tuple[int, int]) -> torch.Tensor:
    """resize_linear for [..., H, W, C] channel-last data."""
    return resize_linear(torch.movedim(img, -1, -3), dst_hw).movedim(-3, -1)
