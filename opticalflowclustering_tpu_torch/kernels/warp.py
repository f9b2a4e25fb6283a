"""The Farneback inner loop on the card: warp+M and box-solve CUDA kernels
(port of `opticalflowclustering_tpu/kernels/warp.py`).

Two kernels, written by hand for sm_90a in `csrc/`:

  warp_m    (csrc/warp_m.cu; replaces `_warp_m_kernel`, reference
            kernels/warp.py:177, entry `fused_m_planes` :581) — one thread per
            output pixel: exact bilinear sample of R1's 5 coefficient planes
            at (x+dx, y+dy), the reach masks |y1−y| ≤ 119 and |x1−x| ≤ 127,
            then `_m_build` in the reference's op order → M [B, 5, H, W].
  box_solve (csrc/box_solve.cu; replaces `_solve_kernel`, reference
            kernels/warp.py:338, entry `fused_solve` :655) — winsize×winsize
            box sum of M with a replicate border (symmetric-pair order, as
            `ops.filters.box_sum`), ×1/winsize², then the 2×2 solve with
            det + 1e-3 → fx, fy [B, H, W]. winsize odd and ≤ 17.

The TPU layout is gone: r0, r1 and M are unpadded contiguous channel-first
[B, 5, H, W] float32 and the flow is two planes [B, H, W]. 'fast16' rounds
R1's channels 0–3 through bf16 once per pyramid level (`quantize_r1_fast16`,
a plain step on the device) and then runs the same warp_m kernel, which is
the value the reference's packed kernel unpacks.

`warp_m` and `box_solve` are the wrappers the flow calls: for a CPU tensor
they run the plain versions (`warp_m_reference`, `box_solve_reference`);
for a CUDA tensor they launch the kernel or raise. `LAUNCHES` counts kernel
launches, so a run can show that its main path went through the kernels.

The kernels are built at first use by `kernels.build.build`, one build for
all of the port's kernels, compiled with `--fmad=false`: without
multiply-add contraction the kernels run the same float32 operations in the
same order as the plain versions, so the two agree bit for bit. A build or
launch that fails raises.
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.flow.farneback import (
    MAX_KERNEL_WINSIZE,
    _update_flow,
    _update_matrices,
)
from opticalflowclustering_tpu_torch.kernels.build import build
from opticalflowclustering_tpu_torch.runtime import f32

_REACH_Y = 119  # vertical reach of the reference's candidate window
_REACH_X = 127  # horizontal reach of the reference's 3-tile lane window

# Kernel launches per wrapper; `reset_launches` sets them to 0.
LAUNCHES = {"warp_m": 0, "box_solve": 0}

# Bytes per pixel each kernel must move, every input read once and every
# output written once, in float32: warp_m reads R0 (5 planes), R1 (5) and
# the flow (2) and writes M (5); box_solve reads M (5) and writes fx, fy (2).
BYTES_PER_PIXEL = {"warp_m": 4 * (5 + 5 + 2 + 5), "box_solve": 4 * (5 + 2)}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def kernel_bytes(name: str, b: int, h: int, w: int) -> int:
    """Bytes kernel `name` must move for B frames of H×W."""
    return BYTES_PER_PIXEL[name] * b * h * w


def kernel_ops(name: str, b: int, h: int, w: int, winsize: int = 15) -> int:
    """Float32 adds, multiplies and divides kernel `name` does for B frames of
    H×W. warp_m: 101 per pixel (8 for the sample coordinates and weights, 55
    for the bilinear sample of 5 planes, 18 for R2..R6, 6 for the taper, 14
    for M). box_solve: 2r adds per pass and channel, 5 scalings and the
    13-operation solve, 20r + 18 per pixel with r = winsize // 2."""
    per_pixel = {"warp_m": 101, "box_solve": 20 * (winsize // 2) + 18}[name]
    return per_pixel * b * h * w


def quantize_r1_fast16(r1: torch.Tensor) -> torch.Tensor:
    """Channel-first [..., 5, H, W] r1 with channels 0–3 rounded through
    bf16 (round to nearest even) and channel 4 exact — the values the
    reference's packed 'fast16' kernel unpacks."""
    q = r1[..., :4, :, :].to(torch.bfloat16).to(torch.float32)
    return torch.cat([q, r1[..., 4:, :, :]], dim=-3)


def warp_m_reference(
    r0: torch.Tensor, r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
) -> torch.Tensor:
    """Plain version of the warp_m kernel: the reference's
    `update_matrices_gather` (kernels/warp.py:713), channel-first.
    r0, r1: [B, 5, H, W]; fx, fy: [B, H, W] → M [B, 5, H, W]."""
    return _update_matrices(r0, r1, fx, fy, reach=(_REACH_Y, _REACH_X))


def box_solve_reference(
    m: torch.Tensor, winsize: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the box_solve kernel: `_update_flow(m, winsize,
    gaussian=False)`. m: [B, 5, H, W] → (fx, fy) [B, H, W]."""
    return _update_flow(m, winsize, gaussian=False)


def _check_cuda_f32(name: str, t: torch.Tensor, shape: tuple, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def warp_m_cuda(
    r0: torch.Tensor, r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
) -> torch.Tensor:
    """Launch the warp_m kernel: r0, r1 [B, 5, H, W] and fx, fy [B, H, W],
    contiguous float32 CUDA tensors → M [B, 5, H, W]."""
    if r0.ndim != 4 or r0.shape[1] != 5:
        raise ValueError(f"r0 must be [B, 5, H, W], got {tuple(r0.shape)}")
    b, _, h, w = r0.shape
    if h < 2 or w < 2:
        raise ValueError(f"warp_m needs H, W >= 2, got {h}x{w}")
    _check_cuda_f32("r0", r0, (b, 5, h, w), r0.device)
    _check_cuda_f32("r1", r1, (b, 5, h, w), r0.device)
    _check_cuda_f32("fx", fx, (b, h, w), r0.device)
    _check_cuda_f32("fy", fy, (b, h, w), r0.device)
    ext = build()
    m = torch.empty_like(r0)
    ext.warp_m(r0, r1, fx, fy, m)
    LAUNCHES["warp_m"] += 1
    return m


def box_solve_cuda(
    m: torch.Tensor, winsize: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the box_solve kernel on contiguous float32 CUDA M
    [B, 5, H, W] → (fx, fy) [B, H, W]; winsize odd and ≤ 17."""
    if winsize % 2 != 1 or not 1 <= winsize <= MAX_KERNEL_WINSIZE:
        raise ValueError(
            f"box_solve needs an odd winsize <= {MAX_KERNEL_WINSIZE}, got {winsize}"
        )
    if m.ndim != 4 or m.shape[1] != 5:
        raise ValueError(f"m must be [B, 5, H, W], got {tuple(m.shape)}")
    b, _, h, w = m.shape
    _check_cuda_f32("m", m, (b, 5, h, w), m.device)
    ext = build()
    fx = torch.empty((b, h, w), dtype=torch.float32, device=m.device)
    fy = torch.empty_like(fx)
    ext.box_solve(m, fx, fy, winsize // 2, f32(1.0 / (winsize * winsize)))
    LAUNCHES["box_solve"] += 1
    return fx, fy


def warp_m(
    r0: torch.Tensor, r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
) -> torch.Tensor:
    """M [B, 5, H, W]: the plain version for CPU tensors, else the kernel."""
    if r0.device.type == "cpu":
        return warp_m_reference(r0, r1, fx, fy)
    return warp_m_cuda(r0, r1, fx, fy)


def box_solve(m: torch.Tensor, winsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(fx, fy) [B, H, W]: the plain version for a CPU tensor, else the kernel."""
    if m.device.type == "cpu":
        return box_solve_reference(m, winsize)
    return box_solve_cuda(m, winsize)
