"""The polynomial expansion of one pyramid level on the card.

One kernel, written by hand for sm_90a in `csrc/poly_expansion.cu`. It
replaces no Pallas kernel (the JAX package leaves this stage to XLA): it
takes the place of the plain stage's 158 eager operators and two blocking
index uploads a call. float32 [B, H, W] → channel-first [B, 5, H, W], bit
for bit the plain version (`poly_expansion_reference`), which
`flow.farneback.poly_expansion` runs for a CPU tensor and for n above
`MAX_KERNEL_POLY_N`.

`poly_expansion` launches the kernel on a contiguous float32 CUDA tensor
and 1 ≤ n ≤ `MAX_KERNEL_POLY_N`, and raises on anything else (an empty
frame or more than 65535 images through the launcher's refusal).
`LAUNCHES` counts its launches, apart from `kernels.warp.LAUNCHES`, so a
run can show that its flow went through it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch.flow.farneback import (
    MAX_KERNEL_POLY_N,
    _poly_exp_consts,
    _poly_expansion_plain,
)
from opticalflowclustering_tpu_torch.kernels.build import build

# Kernel launches; `reset_launches` sets them to 0.
LAUNCHES = {"poly_expansion": 0}

# Bytes per pixel the kernel must move: the image read once, the 5 planes
# written once, float32.
BYTES_PER_PIXEL = 4 * (1 + 5)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_bytes(b: int, h: int, w: int) -> int:
    """Bytes the kernel must move for B images of H×W."""
    return BYTES_PER_PIXEL * b * h * w


def kernel_ops(n: int, b: int, h: int, w: int) -> int:
    """Float32 adds and multiplies the expansion needs for B images of H×W:
    8n + 1 a pixel vertically (per tap pair one sum, one difference, three
    products and three accumulations), 17n + 10 horizontally (five sums and
    differences, six products and six accumulations per tap pair, three
    products at the centre, seven to combine), 25n + 11 in all."""
    return (25 * n + 11) * b * h * w


@functools.lru_cache(maxsize=32)
def _taps(n: int, sigma: float) -> torch.Tensor:
    """The kernel's constants, a CPU float32 vector: g, xg, xxg at n .. 2n,
    then ig11, ig03, ig33, ig55 rounded to float32."""
    g, xg, xxg, *inv = _poly_exp_consts(n, sigma)
    return torch.from_numpy(
        np.concatenate([g[n:], xg[n:], xxg[n:], np.asarray(inv, dtype=np.float32)])
    )


def poly_expansion_reference(x: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Plain version of the kernel on any device: [B, H, W] → [B, 5, H, W]."""
    return _poly_expansion_plain(x, n, sigma, channel_first=True)


def poly_expansion(x: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Launch the kernel: x a contiguous float32 CUDA [B, H, W], 1 ≤ n ≤
    `MAX_KERNEL_POLY_N` → [B, 5, H, W]."""
    if x.ndim != 3:
        raise ValueError(f"x must be [B, H, W], got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if not 1 <= n <= MAX_KERNEL_POLY_N:
        raise ValueError(f"poly_expansion needs 1 <= n <= {MAX_KERNEL_POLY_N}, got {n}")
    b, h, w = x.shape
    out = torch.empty((b, 5, h, w), dtype=torch.float32, device=x.device)
    build().poly_expansion(x, out, n, _taps(n, sigma))
    LAUNCHES["poly_expansion"] += 1
    return out
