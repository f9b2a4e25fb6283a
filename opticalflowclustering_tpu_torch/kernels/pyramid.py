"""The blur and downsample of one Farneback pyramid level on the card.

One kernel, written by hand for sm_90a in `csrc/pyramid.cu`. It replaces
no Pallas kernel (the JAX package leaves this stage to XLA): it takes the
place of the plain stage's full-frame operators, one per tap pair and axis
(10 to 124 a level and image), and of its two stream-synchronising index
uploads. float32 [B, H, W] → [B, Ho, Wo], bit for bit the plain version
(`pyramid_reference`: `resize_linear(gaussian_blur(x, ksize, sigma,
"reflect101"), (Ho, Wo))`), which `flow.farneback.farneback_flow` runs for
a CPU tensor and for a level the kernel does not take
(`pyramid_kernel_takes`).

`pyramid_level` launches the kernel on a contiguous float32 CUDA tensor
whose sides the level's divide, with a radius ksize // 2 of at most
`MAX_KERNEL_PYRAMID_RADIUS` and below each side, and raises on anything
else. `LAUNCHES` counts its launches, apart from the other kernels', so a
run can show that its pyramid went through it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch.flow.farneback import MAX_KERNEL_PYRAMID_RADIUS
from opticalflowclustering_tpu_torch.kernels.build import build
from opticalflowclustering_tpu_torch.ops.filters import gaussian_blur, gaussian_kernel
from opticalflowclustering_tpu_torch.ops.resize import resize_linear

# Kernel launches; `reset_launches` sets them to 0.
LAUNCHES = {"pyramid": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_bytes(b: int, h: int, w: int, ho: int, wo: int) -> int:
    """Bytes the kernel must move for B images of H×W to Ho×Wo: the frames
    read once, the level written once, float32."""
    return 4 * b * (h * w + ho * wo)


def kernel_ops(ksize: int, b: int, h: int, w: int, ho: int, wo: int) -> int:
    """Float32 adds and multiplies the level needs for B images: the
    vertical sums at the rows the downsample reads (ny a level row: 2 for an
    even factor, else 1) over every column, the horizontal sums at the
    columns it reads (nx an output), 3r + 1 each (a product at the centre,
    then per tap pair a sum, a product and an accumulation), and 3 for each
    two-tap average of the downsample."""
    r = ksize // 2
    ny = 2 if (h // ho) % 2 == 0 else 1
    nx = 2 if (w // wo) % 2 == 0 else 1
    sums = ny * ho * w + ny * ho * nx * wo
    avgs = (ho * nx * wo if ny == 2 else 0) + (ho * wo if nx == 2 else 0)
    return b * ((3 * r + 1) * sums + 3 * avgs)


@functools.lru_cache(maxsize=64)
def _taps(ksize: int, sigma: float) -> torch.Tensor:
    """The kernel's weights, a CPU float32 vector of ksize // 2 + 1: the
    weight at distance 0 .. r, each as `sep_filter_axis` rounds it."""
    k = gaussian_kernel(ksize, sigma)
    r = ksize // 2
    if ksize % 2 == 0 or not np.allclose(k, k[::-1], rtol=1e-9, atol=0.0):
        raise ValueError(f"the kernel takes an odd symmetric window, got ksize {ksize}")
    return torch.from_numpy(k[r::-1].astype(np.float32).copy())


def pyramid_reference(
    x: torch.Tensor, ksize: int, sigma: float, level_hw: tuple[int, int]
) -> torch.Tensor:
    """Plain version of the kernel on any device: [..., H, W] → [..., Ho, Wo]."""
    return resize_linear(gaussian_blur(x, ksize, sigma, border="reflect101"), level_hw)


def pyramid_level(
    x: torch.Tensor, ksize: int, sigma: float, level_hw: tuple[int, int]
) -> torch.Tensor:
    """Launch the kernel: x a contiguous float32 CUDA [B, H, W] → [B, Ho, Wo]."""
    if x.ndim != 3:
        raise ValueError(f"x must be [B, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, h, w = x.shape
    ho, wo = level_hw
    if not (0 < ho <= h and 0 < wo <= w and h % ho == 0 and w % wo == 0):
        raise ValueError(f"the level's sides must divide the frame's: {(h, w)} to {(ho, wo)}")
    r = ksize // 2
    if ksize % 2 == 0 or r > MAX_KERNEL_PYRAMID_RADIUS or r >= min(h, w):
        raise ValueError(
            f"pyramid_level needs an odd ksize whose radius is at most {MAX_KERNEL_PYRAMID_RADIUS} "
            f"and below each side, got ksize {ksize} on {(h, w)}"
        )
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    out = torch.empty((b, ho, wo), dtype=torch.float32, device=x.device)
    build().pyramid_level(x, out, r, _taps(ksize, sigma))
    LAUNCHES["pyramid"] += 1
    return out
