"""The Farneback inner loop on the card: warp+M, box-solve and
Gaussian-solve CUDA kernels (port of `opticalflowclustering_tpu/kernels/warp.py`).

Three kernels, written by hand for sm_90a in `csrc/`:

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
  gauss_solve (csrc/gauss_solve.cu; replaces no Pallas kernel: the JAX
            package leaves OpenCV's Gaussian window to plain jnp,
            `_update_flow(m, winsize, gaussian=True)`) — the same solve
            over the separable Gaussian window of `flow.farneback.gauss_window`
            (replicate border, symmetric-pair order, no scaling).
            2 ≤ winsize ≤ 17.

The TPU layout is gone: r0, r1 and M are unpadded contiguous channel-first
[B, 5, H, W] float32 and the flow is two planes [B, H, W]. 'fast16' rounds
R1's channels 0–3 through bf16 once per pyramid level (`quantize_r1_fast16`,
a plain step on the device) and then runs the same warp_m kernel, which is
the value the reference's packed kernel unpacks.

`warp_m`, `box_solve` and `gauss_solve` are the entries the flow calls
where `flow_takes` holds for its parameters: on the card, for a window the
solve's kernel takes (`box_solve_takes`, `gauss_solve_takes`), they launch
the kernel (`*_cuda`); everywhere else they run the plain versions
(`*_reference`), which import the flow's stage functions where they run,
since `flow.farneback` imports this module.

The kernels are built at first use by `kernels.build.build`, one build for
all of the port's kernels, compiled with `--fmad=false`: without
multiply-add contraction the kernels run the same float32 operations in the
same order as the plain versions, so the two agree bit for bit. A build or
launch that fails raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch import kernels
from opticalflowclustering_tpu_torch.kernels.build import build
from opticalflowclustering_tpu_torch.runtime import f32

_REACH_Y = 119  # vertical reach of the reference's candidate window
_REACH_X = 127  # horizontal reach of the reference's 3-tile lane window
# The box- and Gaussian-solve kernels stage a halo of at most 8 rows/columns.
MAX_KERNEL_WINSIZE = 17

# Bytes per pixel each kernel must move, every input read once and every
# output written once, in float32: warp_m reads R0 (5 planes), R1 (5) and
# the flow (2) and writes M (5); box_solve and gauss_solve read M (5) and
# write fx, fy (2).
BYTES_PER_PIXEL = {"warp_m": 4 * (5 + 5 + 2 + 5), "box_solve": 4 * (5 + 2), "gauss_solve": 4 * (5 + 2)}


def kernel_bytes(name: str, b: int, h: int, w: int) -> int:
    """Bytes kernel `name` must move for B frames of H×W."""
    return BYTES_PER_PIXEL[name] * b * h * w


def kernel_ops(name: str, b: int, h: int, w: int, winsize: int = 15) -> int:
    """Float32 adds, multiplies and divides kernel `name` does for B frames of
    H×W. warp_m: 101 per pixel (8 for the sample coordinates and weights, 55
    for the bilinear sample of 5 planes, 18 for R2..R6, 6 for the taper, 14
    for M). box_solve: 2r adds per pass and channel, 5 scalings and the
    13-operation solve, 20r + 18 per pixel with r = winsize // 2.
    gauss_solve: per pass and channel one product at the centre and an
    add, a product and an accumulation per tap pair, then the solve,
    30r + 23 per pixel."""
    r = winsize // 2
    per_pixel = {"warp_m": 101, "box_solve": 20 * r + 18, "gauss_solve": 30 * r + 23}[name]
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
    from opticalflowclustering_tpu_torch.flow.farneback import _update_matrices

    return _update_matrices(r0, r1, fx, fy, reach=(_REACH_Y, _REACH_X))


def box_solve_reference(
    m: torch.Tensor, winsize: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the box_solve kernel: `_update_flow(m, winsize,
    gaussian=False)`. m: [B, 5, H, W] → (fx, fy) [B, H, W]."""
    from opticalflowclustering_tpu_torch.flow.farneback import _update_flow

    return _update_flow(m, winsize, gaussian=False)


def gauss_solve_reference(
    m: torch.Tensor, winsize: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the gauss_solve kernel: `_update_flow(m, winsize,
    gaussian=True)`. m: [B, 5, H, W] → (fx, fy) [B, H, W]."""
    from opticalflowclustering_tpu_torch.flow.farneback import _update_flow

    return _update_flow(m, winsize, gaussian=True)


@functools.lru_cache(maxsize=16)
def gauss_taps(winsize: int) -> torch.Tensor:
    """The gauss_solve kernel's weights, a CPU float32 vector of
    winsize // 2 + 1: the centre's, then one per distance, the taps the
    plain version reads (`kern[r - d]`), rounded as it rounds them."""
    from opticalflowclustering_tpu_torch.flow.farneback import gauss_window

    kern = gauss_window(winsize)
    return torch.from_numpy(np.ascontiguousarray(kern[winsize // 2 :: -1], dtype=np.float32))


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
    kernels.LAUNCHES["warp_m"] += 1
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
    kernels.LAUNCHES["box_solve"] += 1
    return fx, fy


def gauss_solve_cuda(
    m: torch.Tensor, winsize: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the gauss_solve kernel on contiguous float32 CUDA M
    [B, 5, H, W] → (fx, fy) [B, H, W]; 2 ≤ winsize ≤ 17."""
    if not gauss_solve_takes(winsize):
        raise ValueError(f"gauss_solve needs 2 <= winsize <= {MAX_KERNEL_WINSIZE}, got {winsize}")
    if m.ndim != 4 or m.shape[1] != 5:
        raise ValueError(f"m must be [B, 5, H, W], got {tuple(m.shape)}")
    b, _, h, w = m.shape
    _check_cuda_f32("m", m, (b, 5, h, w), m.device)
    ext = build()
    fx = torch.empty((b, h, w), dtype=torch.float32, device=m.device)
    fy = torch.empty_like(fx)
    ext.gauss_solve(m, fx, fy, winsize // 2, gauss_taps(winsize))
    kernels.LAUNCHES["gauss_solve"] += 1
    return fx, fy


def box_solve_takes(winsize: int) -> bool:
    """Whether the box_solve kernel takes this box window."""
    return winsize <= MAX_KERNEL_WINSIZE


def gauss_solve_takes(winsize: int) -> bool:
    """Whether the gauss_solve kernel takes this Gaussian window: a radius
    winsize // 2 of 1 to 8 (at winsize 1 the plain window's sigma is 0)."""
    return 2 <= winsize <= MAX_KERNEL_WINSIZE


def flow_takes(params) -> bool:
    """Whether a flow of FarnebackParams `params` runs its inner loop
    through `warp_m` and the window's solve: a warp mode whose reach masks
    are the warp_m kernel's ('fast', 'fast16'), with a window the solve's
    kernel takes. Elsewhere the flow's warp and solve stay plain on every
    device, and no warp_m or solve kernel is launched."""
    takes = gauss_solve_takes if params.gaussian_win else box_solve_takes
    return params.warp_mode in ("fast", "fast16") and takes(params.winsize)


def warp_m(
    r0: torch.Tensor, r1: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor
) -> torch.Tensor:
    """M [B, 5, H, W]: the kernel on the card, else the plain version."""
    if kernels.on_card(r0):
        return warp_m_cuda(r0, r1, fx, fy)
    return warp_m_reference(r0, r1, fx, fy)


def box_solve(m: torch.Tensor, winsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(fx, fy) [B, H, W]: the kernel on the card for a window it takes,
    else the plain version."""
    if kernels.on_card(m) and box_solve_takes(winsize):
        return box_solve_cuda(m, winsize)
    return box_solve_reference(m, winsize)


def gauss_solve(m: torch.Tensor, winsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(fx, fy) [B, H, W] over the Gaussian window: the kernel on the card
    for a window it takes, else the plain version."""
    if kernels.on_card(m) and gauss_solve_takes(winsize):
        return gauss_solve_cuda(m, winsize)
    return gauss_solve_reference(m, winsize)
