"""HSV flow rendering (port of `opticalflowclustering_tpu/flow/render.py`),
replicating `ComputeOpticalFLow.compute`
(`k-means-color-clustering/computeOpticalFlowModule.py:24-33`):

  magnitude, angle = cartToPolar(flow_x, flow_y)        # fastAtan2 degrees→rad
  hue   = uint8(angle · 180/π / 2)                      # C-cast truncation
  sat   = 255
  value = uint8(normalize(magnitude, 0, 255, MINMAX))   # per-frame min-max
  bgr   = cvtColor(HSV2BGR)
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.ops.colorspace import hsv2bgr
from opticalflowclustering_tpu_torch.ops.polar import cart_to_polar, normalize_minmax
from opticalflowclustering_tpu_torch.runtime import f32


def _flow_hue_u8(ang: torch.Tensor) -> torch.Tensor:
    """hue = angle_rad * 180/π / 2, C-cast to uint8 (truncation toward 0)."""
    return (ang * f32(180.0 / 3.141592653589793 / 2.0)).to(torch.uint8)


def render_flow_hsv(flow: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 2] float flow → [..., H, W, 3] uint8 HSV image."""
    mag, ang = cart_to_polar(flow[..., 0], flow[..., 1])
    hue = _flow_hue_u8(ang)
    val = normalize_minmax(mag, 0.0, 255.0, axis=(-2, -1)).to(torch.uint8)
    sat = torch.full_like(hue, 255)
    return torch.stack([hue, sat, val], dim=-1)


def render_flow_hsv_bgr(flow: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 2] float flow → [..., H, W, 3] uint8 BGR flow image."""
    return hsv2bgr(render_flow_hsv(flow))
