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
from opticalflowclustering_tpu_torch.ops.polar import cart_to_polar, normalize_minmax_given_range
from opticalflowclustering_tpu_torch.runtime import f32


def _flow_hue_u8(ang: torch.Tensor) -> torch.Tensor:
    """hue = angle_rad * 180/π / 2, C-cast to uint8 (truncation toward 0)."""
    return (ang * f32(180.0 / 3.141592653589793 / 2.0)).to(torch.uint8)


def _render_hsv(flow: torch.Tensor, smin=None, smax=None) -> torch.Tensor:
    """[..., H, W, 2] float flow → [..., H, W, 3] uint8 HSV image, the value
    normalized over the magnitude range [smin, smax] (default: each frame's
    own)."""
    mag, ang = cart_to_polar(flow[..., 0], flow[..., 1])
    if smin is None:
        smin = torch.amin(mag, dim=(-2, -1), keepdim=True)
        smax = torch.amax(mag, dim=(-2, -1), keepdim=True)
    hue = _flow_hue_u8(ang)
    val = normalize_minmax_given_range(mag, smin, smax, 0.0, 255.0).to(torch.uint8)
    sat = torch.full_like(hue, 255)
    return torch.stack([hue, sat, val], dim=-1)


def render_flow_hsv(flow: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 2] float flow → [..., H, W, 3] uint8 HSV image."""
    return _render_hsv(flow)


def render_flow_hsv_bgr(flow: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 2] float flow → [..., H, W, 3] uint8 BGR flow image."""
    return hsv2bgr(_render_hsv(flow))


def render_flow_hsv_bgr_given_range(
    flow: torch.Tensor, smin: torch.Tensor, smax: torch.Tensor
) -> torch.Tensor:
    """render_flow_hsv_bgr with the per-frame magnitude range given
    (smin/smax broadcastable to [..., 1, 1]): the row-sharded pipeline
    (`parallel/spatial.spatial_hue_pipeline`) takes the frame's min and max
    over its shards, which equal the unsharded reduction exactly, so the
    rendered bytes are the unsharded render's."""
    return hsv2bgr(_render_hsv(flow, smin, smax))
