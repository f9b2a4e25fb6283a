"""cv2.cartToPolar / cv2.normalize equivalents (port of
`opticalflowclustering_tpu/ops/polar.py`).

The angle is OpenCV's `fastAtan2` degree-domain polynomial, evaluated in
float32 in the reference's order, so the flow hues match it bit for bit.
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.runtime import f32

# OpenCV fastAtan2 polynomial coefficients (degrees domain).
_ATAN2_P1 = 0.9997878412794807 * (180.0 / 3.141592653589793)
_ATAN2_P3 = -0.3258083974640975 * (180.0 / 3.141592653589793)
_ATAN2_P5 = 0.1555786518463281 * (180.0 / 3.141592653589793)
_ATAN2_P7 = -0.04432655554792128 * (180.0 / 3.141592653589793)
_DBL_EPSILON = 2.220446049250313e-16


def fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """OpenCV fastAtan2: angle of (x, y) in degrees in [0, 360)."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    ax, ay = x.abs(), y.abs()
    lo = torch.minimum(ax, ay)
    hi = torch.maximum(ax, ay)
    c = lo / (hi + f32(_DBL_EPSILON))
    c2 = c * c
    poly = (
        ((f32(_ATAN2_P7) * c2 + f32(_ATAN2_P5)) * c2 + f32(_ATAN2_P3)) * c2
        + f32(_ATAN2_P1)
    ) * c
    a = torch.where(ax >= ay, poly, 90.0 - poly)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def magnitude(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """cv2.magnitude: sqrt(x² + y²) in float32."""
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    return torch.sqrt(x * x + y * y)


def cart_to_polar(
    x: torch.Tensor, y: torch.Tensor, angle_in_degrees: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """cv2.cartToPolar: (magnitude, angle); radians are the degree result
    times π/180, as OpenCV does it."""
    mag = magnitude(x, y)
    ang = fast_atan2_deg(y, x)
    if not angle_in_degrees:
        ang = ang * f32(3.141592653589793 / 180.0)
    return mag, ang


def normalize_minmax(
    x: torch.Tensor, alpha: float = 0.0, beta: float = 255.0, axis=None
) -> torch.Tensor:
    """cv2.normalize(x, None, alpha, beta, cv2.NORM_MINMAX) in float32;
    `axis` normalizes each frame of a batch on its own."""
    x = x.to(torch.float32)
    if axis is None:
        smin, smax = x.min(), x.max()
    else:
        smin = torch.amin(x, dim=axis, keepdim=True)
        smax = torch.amax(x, dim=axis, keepdim=True)
    return normalize_minmax_given_range(x, smin, smax, alpha, beta)


def normalize_minmax_given_range(
    x: torch.Tensor,
    smin: torch.Tensor,
    smax: torch.Tensor,
    alpha: float = 0.0,
    beta: float = 255.0,
) -> torch.Tensor:
    """The scale/shift chain of `normalize_minmax` for a given source range;
    the one chain every render path shares."""
    x = x.to(torch.float32)
    dmin, dmax = f32(min(alpha, beta)), f32(max(alpha, beta))
    delta = smax - smin
    # One float32 division, as in the reference (`scalar / tensor` in
    # PyTorch is a reciprocal and a multiply, two roundings).
    scale = torch.where(
        delta > f32(_DBL_EPSILON), torch.full_like(delta, dmax - dmin) / delta, 0.0
    )
    shift = dmin - smin * scale
    return x * scale + shift
