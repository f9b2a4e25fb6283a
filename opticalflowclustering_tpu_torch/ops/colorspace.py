"""OpenCV-exact colour conversions (port of `opticalflowclustering_tpu/ops/colorspace.py`).

OpenCV's uint8 conversions are fixed-point integer algorithms, and the golden
hue tables depend on every bit of them, so the integer paths here are the
JAX package's arithmetic step for step in int32 and are bitwise equal to it.
All functions take channel-last uint8 tensors with any leading dims.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import f32

# OpenCV 5.x BT.601 gray, 15-bit fixed point (coefficients sum to 1 << 15).
_YUV_SHIFT = 15
_R2Y, _G2Y, _B2Y = 9798, 19235, 3735
_HSV_SHIFT = 12


@functools.lru_cache(maxsize=1)
def _hsv_div_tables() -> tuple[np.ndarray, np.ndarray]:
    """OpenCV's sdiv/hdiv tables: saturate_cast<int>((255<<12)/i) and
    ((180<<12)/(6*i)), with entry 0 = 0."""
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.rint((255 << _HSV_SHIFT) / i)
        hdiv = np.rint((180 << _HSV_SHIFT) / (6.0 * i))
    sdiv[0] = 0
    hdiv[0] = 0
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


def bgr2gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_BGR2GRAY) for uint8:
    y = (B*3735 + G*19235 + R*9798 + (1<<14)) >> 15."""
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (b * _B2Y + g * _G2Y + r * _R2Y + (1 << (_YUV_SHIFT - 1))) >> _YUV_SHIFT
    return y.to(torch.uint8)


def rgb2gray(rgb: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_RGB2GRAY) for uint8: bgr2gray of the flipped
    channels."""
    return bgr2gray(rgb.flip(-1))


def bgr2rgb(x: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_BGR2RGB): a channel flip."""
    return x.flip(-1)


def bgr2hsv(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_BGR2HSV) for uint8 (hsv_shift=12 with the
    division tables); H in [0,180), S and V in [0,255]."""
    sdiv_np, hdiv_np = _hsv_div_tables()
    sdiv = torch.from_numpy(sdiv_np).to(bgr.device)
    hdiv = torch.from_numpy(hdiv_np).to(bgr.device)

    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    vmin = torch.minimum(torch.minimum(b, g), r)
    diff = v - vmin

    s = (diff * sdiv[v.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(
        v == r,
        g - b,
        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff),
    )
    # Arithmetic right shift of a negative int32 is floor division by 4096,
    # as in OpenCV's C code and the JAX reference.
    h = (h * hdiv[diff.long()] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


# OpenCV HSV2RGB sector table, BGR output order.
_SECTOR_DATA = np.array(
    [[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]],
    dtype=np.int32,
)


def hsv2bgr(hsv: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_HSV2BGR) for uint8 through OpenCV's float32
    scalar path (round half to even back to uint8). OpenCV builds with IPP
    send large images to a kernel that truncates instead (±1); like the JAX
    reference, this is the scalar algorithm."""
    h = hsv[..., 0].to(torch.float32) * f32(6.0 / 180.0)
    s = hsv[..., 1].to(torch.float32) * f32(1.0 / 255.0)
    v = hsv[..., 2].to(torch.float32) * f32(1.0 / 255.0)

    h = h - 6.0 * torch.trunc(h * f32(1.0 / 6.0))
    sector = torch.clamp(torch.floor(h).to(torch.int32), 0, 5)
    f = h - sector.to(torch.float32)

    tab = (v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f)))
    channels = []
    for ch in range(3):
        val = tab[_SECTOR_DATA[0][ch]]
        for sec in range(1, 6):
            val = torch.where(sector == sec, tab[_SECTOR_DATA[sec][ch]], val)
        channels.append(val)
    bgr = torch.stack(channels, dim=-1)
    return torch.clamp(torch.round(bgr * 255.0), 0, 255).to(torch.uint8)
