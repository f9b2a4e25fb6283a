"""CIE L*a*b* conversions, OpenCV's uint8 convention (port of
`opticalflowclustering_tpu/ops/lab.py`).

OpenCV's uint8 Lab: sRGB linearised, linear XYZ (D65-scaled matrix), the
0.008856 cube-root/linear split, then L·255/100 and a, b + 128 rounded to
uint8. Computed in float32 with the JAX module's constants and order.
PyTorch has no cbrt: the cube root is taken as a float64 pow with the
exponent float32(1/3), rounded to float32, which is how XLA computes
`jnp.cbrt` on the CPU. Over all 2^24 BGR inputs, 9 of the 50,331,648 codes
of `bgr2lab` and 10 of `lab2bgr` differ from eager JAX, each by 1
(tests/test_torch_kmeans.py); float32 pow itself differs between torch and
XLA, so exact equality is out of reach.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import f32

_XN, _YN, _ZN = 0.950456, 1.0, 1.088754
_T = 0.008856
_M = (
    (0.412453, 0.357580, 0.180423),
    (0.212671, 0.715160, 0.072169),
    (0.019334, 0.119193, 0.950227),
)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    return t.clamp_min(0).to(torch.float64).pow(float(np.float32(1.0 / 3.0))).to(torch.float32)


def _f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > f32(_T), _cbrt(t), f32(7.787) * t + f32(16.0 / 116.0))


def _srgb_to_linear(u: torch.Tensor) -> torch.Tensor:
    return torch.where(
        u <= f32(0.04045),
        u * f32(1.0 / 12.92),
        ((u + f32(0.055)) * f32(1.0 / 1.055)) ** f32(2.4),
    )


def _linear_to_srgb(u: torch.Tensor) -> torch.Tensor:
    u = torch.clamp(u, min=0.0)
    return torch.where(
        u <= f32(0.0031308),
        u * f32(12.92),
        f32(1.055) * u ** f32(1.0 / 2.4) - f32(0.055),
    )


def _to_u8(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0, 255).to(torch.uint8)


def bgr2lab(bgr: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_BGR2LAB) for uint8 [..., 3] (±1 vs cv2's fixed
    point)."""
    b = _srgb_to_linear(bgr[..., 0].to(torch.float32) * f32(1.0 / 255.0))
    g = _srgb_to_linear(bgr[..., 1].to(torch.float32) * f32(1.0 / 255.0))
    r = _srgb_to_linear(bgr[..., 2].to(torch.float32) * f32(1.0 / 255.0))
    x = (f32(_M[0][0]) * r + f32(_M[0][1]) * g + f32(_M[0][2]) * b) / f32(_XN)
    y = f32(_M[1][0]) * r + f32(_M[1][1]) * g + f32(_M[1][2]) * b
    z = (f32(_M[2][0]) * r + f32(_M[2][1]) * g + f32(_M[2][2]) * b) / f32(_ZN)
    fx, fy, fz = _f(x), _f(y), _f(z)
    lum = torch.where(y > f32(_T), f32(116.0) * fy - f32(16.0), f32(903.3) * y)
    a = f32(500.0) * (fx - fy) + f32(128.0)
    bb = f32(200.0) * (fy - fz) + f32(128.0)
    return _to_u8(torch.stack([lum * f32(255.0 / 100.0), a, bb], dim=-1))


def lab2bgr(lab: torch.Tensor) -> torch.Tensor:
    """cv2.cvtColor(x, COLOR_LAB2BGR) for uint8 [..., 3] (±2 vs cv2)."""
    lum = lab[..., 0].to(torch.float32) * f32(100.0 / 255.0)
    a = lab[..., 1].to(torch.float32) - f32(128.0)
    bb = lab[..., 2].to(torch.float32) - f32(128.0)
    fy = (lum + f32(16.0)) * f32(1.0 / 116.0)
    fx = fy + a * f32(1.0 / 500.0)
    fz = fy - bb * f32(1.0 / 200.0)

    def inv_f(ft):
        t3 = ft * ft * ft
        return torch.where(t3 > f32(_T), t3, (ft - f32(16.0 / 116.0)) / f32(7.787))

    y = torch.where(lum > f32(903.3 * _T), fy * fy * fy, lum * f32(1.0 / 903.3))
    x = inv_f(fx) * f32(_XN)
    z = inv_f(fz) * f32(_ZN)
    r = f32(3.240479) * x + f32(-1.53715) * y + f32(-0.498535) * z
    g = f32(-0.969256) * x + f32(1.875991) * y + f32(0.041556) * z
    b = f32(0.055648) * x + f32(-0.204043) * y + f32(1.057311) * z
    bgr = torch.stack([_linear_to_srgb(b), _linear_to_srgb(g), _linear_to_srgb(r)], dim=-1)
    return _to_u8(bgr * f32(255.0))
