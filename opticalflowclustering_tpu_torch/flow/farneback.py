"""Farneback dense optical flow (port of `opticalflowclustering_tpu/flow/farneback.py`).

The algorithm behind `cv2.calcOpticalFlowFarneback`, with the reference
pipeline's parameters (0.5, 3, 15, 3, 5, 1.2, 0) as defaults:

  per pyramid level k = levels..0 (resampled from the full-resolution image,
  Gaussian-presmoothed with sigma = (1/scale - 1)/2):
    R_i   = polynomial expansion of each image
    M     = local-system tensor from R_0 and R_1 warped by the current flow
    iter: flow = solve2x2(box_winsize(M));  M = rebuild(flow)   ×iterations

Layout: the polynomial coefficients and M are channel-first [B, 5, H, W]
float32 and the flow travels between steps as two planes fx, fy [B, H, W],
the layout the CUDA kernels take. `farneback_flow` returns the reference's
channel-last [..., H, W, 2].

On a CUDA tensor each pyramid level's blur and downsample is one launch
of the `kernels.pyramid` kernel where the level's sides divide the frame's
(`pyramid_kernel_takes`), and the polynomial expansion one launch of the
`kernels.poly` kernel (n ≤ 8), in every warp mode; a CPU tensor runs their
plain versions. For warp modes 'fast' and 'fast16' with winsize ≤ 17, the
warp+M and solve steps go through `kernels.warp.warp_m` and, by the
window, `box_solve` or `gauss_solve` (OpenCV's OPTFLOW_FARNEBACK_GAUSSIAN,
2 ≤ winsize): the hand-written CUDA kernels for a CUDA tensor, their plain
versions for a CPU tensor. Every other configuration ('exact', 'select',
wider windows) runs the plain PyTorch steps on the caller's device. Each
Gaussian solve, kernel or plain, runs in an `ofc.flow.gauss` span inside
`ofc.flow.solve`.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.filters import (
    box_sum,
    gaussian_blur,
    sep_filter_axis,
)
from opticalflowclustering_tpu_torch.ops.resize import resize_linear
from opticalflowclustering_tpu_torch.runtime import f32
from opticalflowclustering_tpu_torch.utils.profiling import span

_MIN_SIZE = 32  # OpenCV: pyramid levels stop below 32 px on either side
_BORDER = 5
# OpenCV FarnebackUpdateMatrices edge taper.
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], dtype=np.float32)
_WARP_MODES = ("exact", "fast", "fast16", "select")
# The box- and Gaussian-solve kernels stage a halo of at most 8 rows/columns.
MAX_KERNEL_WINSIZE = 17
# The poly-expansion kernel unrolls n up to 8 (OpenCV's poly_n is 5 or 7).
MAX_KERNEL_POLY_N = 8
# The pyramid kernel's taps: ksize 79, pyr_scale 0.5 through level 5.
MAX_KERNEL_PYRAMID_RADIUS = 39


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """cv2.calcOpticalFlowFarneback's parameters; defaults are the
    reference's call (`computeOpticalFlowModule.py:20-22`).

    warp_mode:
      'exact'  — per-pixel bilinear warp, OpenCV-faithful, plain PyTorch.
      'fast'   — the same warp plus the reach masks |y1−y| ≤ 119 and
                 |x1−x| ≤ 127 (beyond them OpenCV's out-of-image fallback
                 applies), run by the warp+M and box-solve CUDA kernels on
                 the card. The CLI default.
      'fast16' — 'fast' with R1's channels 0–3 rounded through bf16.
      'select' — the legacy separable warp (`_warp_select`): a vertical
                 then a horizontal bilinear sample, each from the integer
                 offset clamped to ±warp_radius (halved per pyramid level,
                 floor 8), and the reach masks |y1−y| ≤ warp_radius−1,
                 |x1−x| ≤ 126. Exact for displacements within
                 ±warp_radius whose integer part is locally smooth;
                 inexact at motion discontinuities (the vertical sample
                 read at column x1 used the flow of (y, x1), not (y, x)).
                 Kept for comparison; plain PyTorch on every device.
    warp_radius: 'select' only — the offset clamp at the finest level.
    """

    pyr_scale: float = 0.5
    levels: int = 3
    winsize: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # OPTFLOW_FARNEBACK_GAUSSIAN
    warp_mode: str = "exact"
    warp_radius: int = 32  # 'select' mode only

    def __post_init__(self):
        if self.warp_mode not in _WARP_MODES:
            raise ValueError(
                f"warp_mode {self.warp_mode!r} is not supported by the port "
                f"(choose one of {_WARP_MODES})"
            )


def _cvround(x: float) -> int:
    return int(np.rint(x))


@functools.lru_cache(maxsize=32)
def _poly_exp_consts(n: int, sigma: float):
    """Per-tap weights (g, xg, xxg) and the 4 inverse-Gram coefficients of
    the 6×6 Gaussian-weighted monomial Gram matrix, as OpenCV builds them."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2 * sigma * sigma))
    g /= g.sum()
    # float32 quantization happens in OpenCV before the products; replicate.
    g = g.astype(np.float32).astype(np.float64)
    xg = (x * g).astype(np.float32).astype(np.float64)
    xxg = (x * x * g).astype(np.float32).astype(np.float64)

    G = np.zeros((6, 6), dtype=np.float64)
    for yy in x:
        for xx in x:
            w = g[int(yy) + n] * g[int(xx) + n]
            G[0, 0] += w
            G[1, 1] += w * xx * xx
            G[3, 3] += w * xx**4
            G[5, 5] += w * xx * xx * yy * yy
    G[2, 2] = G[0, 3] = G[0, 4] = G[3, 0] = G[4, 0] = G[1, 1]
    G[4, 4] = G[3, 3]
    G[3, 4] = G[4, 3] = G[5, 5]
    invG = np.linalg.inv(G)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(invG[1, 1]),
        float(invG[0, 3]),
        float(invG[3, 3]),
        float(invG[5, 5]),
    )


def pyramid_ksize(sigma: float) -> int:
    """The presmoothing blur's size at a level of sigma: OpenCV's
    max(cvRound(5σ) | 1, 3)."""
    return max(_cvround(sigma * 5) | 1, 3)


def pyramid_kernel_takes(
    img: torch.Tensor, ksize: int, hw: tuple[int, int], level_hw: tuple[int, int]
) -> bool:
    """Whether `farneback_flow` builds the level of `img` (H×W → h_k×w_k,
    blurred by ksize taps) with the pyramid kernel: a CUDA tensor, each
    side's ratio a whole number, the radius at most the kernel's and below
    each side."""
    (h, w), (h_k, w_k) = hw, level_hw
    r = ksize // 2
    return (
        img.device.type == "cuda"
        and 0 < h_k <= h
        and 0 < w_k <= w
        and h % h_k == 0
        and w % w_k == 0
        and r <= MAX_KERNEL_PYRAMID_RADIUS
        and r < min(h, w)
    )


def poly_kernel_takes(img: torch.Tensor, n: int) -> bool:
    """Whether `poly_expansion` runs the CUDA kernel for this image and n."""
    return img.device.type == "cuda" and n <= MAX_KERNEL_POLY_N


def poly_expansion(
    img: torch.Tensor, n: int, sigma: float, channel_first: bool = False
) -> torch.Tensor:
    """Quadratic polynomial expansion of [..., H, W] → [..., H, W, 5]
    (or [..., 5, H, W] with channel_first=True, the layout the flow uses).

    Channels (OpenCV layout): 0: y-linear, 1: x-linear, 2: y², 3: x², 4: xy.
    A replicate-padded vertical pass (Σg·I, Σxg·I, Σxxg·I), then a
    horizontal pass combining them through the inverse Gram coefficients.
    On the card (n ≤ `MAX_KERNEL_POLY_N`) one launch of the
    `kernels.poly` kernel, bit for bit the plain version, which runs
    everywhere else; channel-last output is then a view of the kernel's
    channel-first planes.
    """
    if poly_kernel_takes(img, n):
        from opticalflowclustering_tpu_torch.kernels import poly as kp

        h, w = img.shape[-2], img.shape[-1]
        x = img.to(torch.float32).reshape(-1, h, w).contiguous()
        out = kp.poly_expansion(x, n, sigma).reshape(img.shape[:-2] + (5, h, w))
        return out if channel_first else out.movedim(-3, -1)
    return _poly_expansion_plain(img, n, sigma, channel_first)


def _poly_expansion_plain(
    img: torch.Tensor, n: int, sigma: float, channel_first: bool = False
) -> torch.Tensor:
    """`poly_expansion` in plain PyTorch, on any device."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    x = img.to(torch.float32)
    h, w = x.shape[-2], x.shape[-1]
    ry, rx = x.ndim - 2, x.ndim - 1
    rows = torch.from_numpy(np.pad(np.arange(h), n, mode="edge")).to(x.device)
    xp = x.index_select(ry, rows)

    def vsl(off):
        return xp.narrow(ry, off, h)

    t0 = f32(g[n]) * vsl(n)
    t1 = torch.zeros_like(t0)
    t2 = torch.zeros_like(t0)
    for k in range(1, n + 1):
        up, down = vsl(n - k), vsl(n + k)
        t0 = t0 + f32(g[n + k]) * (up + down)
        t1 = t1 + f32(xg[n + k]) * (down - up)
        t2 = t2 + f32(xxg[n + k]) * (up + down)

    cols = torch.from_numpy(np.pad(np.arange(w), n, mode="edge")).to(x.device)
    t0p = t0.index_select(rx, cols)
    t1p = t1.index_select(rx, cols)
    t2p = t2.index_select(rx, cols)

    def hsl(a, off):
        return a.narrow(rx, off, w)

    b1 = f32(g[n]) * hsl(t0p, n)
    b3 = f32(g[n]) * hsl(t1p, n)
    b5 = f32(g[n]) * hsl(t2p, n)
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        l0, r0 = hsl(t0p, n - k), hsl(t0p, n + k)
        l1, r1 = hsl(t1p, n - k), hsl(t1p, n + k)
        l2, r2 = hsl(t2p, n - k), hsl(t2p, n + k)
        b1 = b1 + f32(g[n + k]) * (l0 + r0)
        b4 = b4 + f32(xxg[n + k]) * (l0 + r0)
        b2 = b2 + f32(xg[n + k]) * (r0 - l0)
        b6 = b6 + f32(xg[n + k]) * (r1 - l1)
        b3 = b3 + f32(g[n + k]) * (l1 + r1)
        b5 = b5 + f32(g[n + k]) * (l2 + r2)

    return torch.stack(
        [
            b3 * f32(ig11),
            b2 * f32(ig11),
            b5 * f32(ig33) + b1 * f32(ig03),
            b4 * f32(ig33) + b1 * f32(ig03),
            b6 * f32(ig55),
        ],
        dim=-3 if channel_first else -1,
    )


def _border_ramp(n: int) -> np.ndarray:
    """One axis of OpenCV's edge taper: float32 ones with {0.14, 0.14,
    0.4472, 0.4472, 0.4472} multiplied in within 5 px of each end."""
    ramp = np.ones(n, dtype=np.float32)
    for i in range(min(_BORDER, n)):
        ramp[i] *= _BORDER_SCALE[i]
        ramp[n - 1 - i] *= _BORDER_SCALE[i]
    return ramp


@functools.lru_cache(maxsize=64)
def _border_taper(h: int, w: int) -> np.ndarray:
    """OpenCV's per-pixel edge taper: the product of the row and column
    ramps."""
    return _border_ramp(h)[:, None] * _border_ramp(w)[None, :]


def _warp_gather(
    r1: torch.Tensor, y1c: torch.Tensor, x1c: torch.Tensor, fx, fy
) -> torch.Tensor:
    """Exact bilinear warp of channel-first r1 [..., C, H, W] at the clamped
    integer corners (y1c, x1c) [..., Ho, W] with fractions (fx, fy); the
    output grid may have fewer rows than r1 (a row block's M region
    sampling its extended block, `parallel/spatial.py`)."""
    c, h, w = r1.shape[-3], r1.shape[-2], r1.shape[-1]
    ho = y1c.shape[-2]
    lead = tuple(r1.shape[:-3])
    flat = r1.reshape(lead + (c, h * w))
    base = (y1c.to(torch.int64) * w + x1c.to(torch.int64)).reshape(
        lead + (1, ho * w)
    ).expand(lead + (c, ho * w))

    def corner(off):
        return torch.gather(flat, -1, base + off).reshape(lead + (c, ho, w))

    p00, p01, p10, p11 = corner(0), corner(1), corner(w), corner(w + 1)
    fxe = fx.unsqueeze(-3)
    fye = fy.unsqueeze(-3)
    return (
        p00 * (1 - fxe) * (1 - fye)
        + p01 * fxe * (1 - fye)
        + p10 * (1 - fxe) * fye
        + p11 * fxe * fye
    )


def _warp_select(
    r1: torch.Tensor, y1i: torch.Tensor, x1i: torch.Tensor, fx, fy, radius: int
) -> torch.Tensor:
    """The 'select' warp of channel-first r1 [..., C, H, W] (the reference's
    shifted-copy where-chains, `flow/farneback.py:264-298`, as two clamped
    gathers): a vertical bilinear sample at the integer row offset
    clamp(y1i − y, −radius, radius−1) with fraction fy, then a horizontal
    one of that result at clamp(x1i − x, −radius, radius−1) with fx. Rows
    and columns beyond the image repeat the edge (the reference's edge pad).
    y1i, x1i: int32 [..., H, W]; fx, fy: [..., H, W]."""
    c, h, w = r1.shape[-3], r1.shape[-2], r1.shape[-1]
    dev = r1.device
    lead = tuple(y1i.shape[:-2])
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]

    def taps(pos, n, dim, src):
        """src at pos and pos + 1 along dim, each clamped to [0, n)."""
        def at(p):
            idx = p.clamp(0, n - 1).to(torch.int64).unsqueeze(-3)
            return torch.gather(src, dim, idx.expand(lead + (c, h, w)))

        return at(pos), at(pos + 1)

    a0, a1 = taps(ys + torch.clamp(y1i - ys, -radius, radius - 1), h, -2, r1)
    fye = fy.unsqueeze(-3)
    av = a0 * (1 - fye) + a1 * fye
    del a0, a1
    b0, b1 = taps(xs + torch.clamp(x1i - xs, -radius, radius - 1), w, -1, av)
    fxe = fx.unsqueeze(-3)
    return b0 * (1 - fxe) + b1 * fxe


def _m_build(r0c, r1wc, dx, dy, inb, taper):
    """Normal-equation products from warped coefficients, in the
    reference's op order (`flow/farneback.py:299-329`); the CUDA warp+M
    kernel runs the same sequence. r0c, r1wc: 5-tuples of planes; returns
    the 5 M channels (G11, G12, G22, h1, h2). In-bounds pixels average the
    quadratic terms; out-of-bounds keep r0's with the halved cross term
    (OpenCV's constant-motion fallback); then the 5-px border taper."""
    r4 = torch.where(inb, (r0c[2] + r1wc[2]) * 0.5, r0c[2])
    r5 = torch.where(inb, (r0c[3] + r1wc[3]) * 0.5, r0c[3])
    r6 = torch.where(inb, (r0c[4] + r1wc[4]) * 0.25, r0c[4] * 0.5)
    r2 = (r0c[0] - torch.where(inb, r1wc[0], 0.0)) * 0.5
    r3 = (r0c[1] - torch.where(inb, r1wc[1], 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx

    r2 = r2 * taper
    r3 = r3 * taper
    r4 = r4 * taper
    r5 = r5 * taper
    r6 = r6 * taper

    return (
        r4 * r4 + r6 * r6,
        (r4 + r5) * r6,
        r5 * r5 + r6 * r6,
        r4 * r2 + r6 * r3,
        r6 * r2 + r5 * r3,
    )


def _update_matrices(
    r0, r1, dx, dy, reach: tuple[int, int] | None, select_radius: int | None = None
):
    """M = [G11, G12, G22, h1, h2] [..., 5, H, W] from channel-first r0, r1
    and the flow planes dx, dy [..., H, W]. `reach` = (ry, rx) adds the
    reach masks |y1−y| ≤ ry, |x1−x| ≤ rx to the in-bounds test; with
    `select_radius` R1 is warped by `_warp_select` instead of the exact
    bilinear gather."""
    h, w = dx.shape[-2], dx.shape[-1]
    dev = dx.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    gx = xs.to(torch.float32) + dx
    gy = ys.to(torch.float32) + dy
    x1 = torch.floor(gx)
    y1 = torch.floor(gy)
    fx = gx - x1
    fy = gy - y1
    x1i = x1.to(torch.int32)
    y1i = y1.to(torch.int32)
    if select_radius is None:
        x1c = torch.clamp(x1i, 0, w - 2)
        y1c = torch.clamp(y1i, 0, h - 2)
        r1w = _warp_gather(r1, y1c, x1c, fx, fy)
    else:
        r1w = _warp_select(r1, y1i, x1i, fx, fy, select_radius)

    inb = (x1i >= 0) & (x1i <= w - 2) & (y1i >= 0) & (y1i <= h - 2)
    if reach is not None:
        inb = inb & ((y1i - ys).abs() <= reach[0]) & ((x1i - xs).abs() <= reach[1])
    taper = torch.from_numpy(_border_taper(h, w)).to(dev)
    m = _m_build(r0.unbind(-3), r1w.unbind(-3), dx, dy, inb, taper)
    return torch.stack(m, dim=-3)


def update_matrices(
    r0: torch.Tensor,
    r1: torch.Tensor,
    dx: torch.Tensor,
    dy: torch.Tensor,
    warp_mode: str = "exact",
    warp_radius: int = 32,
) -> torch.Tensor:
    """The local-system tensor M [..., 5, H, W] (plain PyTorch).

    r0, r1: [..., 5, H, W]; dx, dy: [..., H, W]. Warps R1 by the flow
    (bilinear, OpenCV's out-of-bounds fallback), averages the quadratic
    coefficients, forms the normal equations of A·d = Δb and tapers the
    5-px border. 'fast'/'fast16' use the kernels' reach masks (their plain
    version, `kernels.warp.warp_m_reference`); 'select' warps by
    `_warp_select` at `warp_radius` and sends displacements beyond
    |y1−y| ≤ warp_radius−1 or |x1−x| ≤ 126 to the out-of-bounds fallback
    (the reference's `update_matrices`, `flow/farneback.py:377-390`)."""
    if warp_mode in ("fast", "fast16"):
        from opticalflowclustering_tpu_torch.kernels.warp import (
            quantize_r1_fast16,
            warp_m_reference,
        )

        if warp_mode == "fast16":
            r1 = quantize_r1_fast16(r1)
        return warp_m_reference(r0, r1, dx, dy)
    if warp_mode == "select":
        return _update_matrices(
            r0, r1, dx, dy, reach=(warp_radius - 1, 126), select_radius=warp_radius
        )
    return _update_matrices(r0, r1, dx, dy, reach=None)


def gauss_window(winsize: int) -> np.ndarray:
    """The Gaussian window's 2·(winsize // 2) + 1 float64 weights: sigma
    0.3·(winsize // 2), normalised to sum 1 (each is rounded to float32
    where it is used)."""
    mhalf = winsize // 2
    sigma = mhalf * 0.3
    x = np.arange(-mhalf, mhalf + 1, dtype=np.float64)
    kern = np.exp(-(x**2) / (2 * sigma * sigma))
    return kern / kern.sum()


def _update_flow(
    m: torch.Tensor, winsize: int, gaussian: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve the windowed 2×2 system of channel-first M [..., 5, H, W]:
    (fx, fy) = G⁻¹h with G, h box- (or Gaussian-) accumulated over
    winsize×winsize, det regularized by 1e-3."""
    if gaussian:
        kern = gauss_window(winsize)
        s = sep_filter_axis(m, kern, axis=-2, border="replicate")
        s = sep_filter_axis(s, kern, axis=-1, border="replicate")
    else:
        s = box_sum(m, winsize, border="replicate", axes=(-2, -1)) * f32(
            1.0 / (winsize * winsize)
        )
    g11, g12, g22, h1, h2 = s.unbind(-3)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + f32(1e-3))
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return fx, fy


def pyramid_plan(
    height: int, width: int, params: FarnebackParams
) -> list[tuple[int, int, int, float]]:
    """Static per-level plan [(k, h_k, w_k, sigma_k)] from coarsest to
    finest, with OpenCV's min-size truncation (stop when either side×scale
    drops below 32)."""
    levels = 0
    scale = 1.0
    for k in range(params.levels):
        scale *= params.pyr_scale
        if width * scale < _MIN_SIZE or height * scale < _MIN_SIZE:
            break
        levels = k + 1
    plan = []
    for k in range(levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        h_k = _cvround(height * scale)
        w_k = _cvround(width * scale)
        plan.append((k, h_k, w_k, sigma))
    return plan


def box_solve_takes(winsize: int) -> bool:
    """Whether the box_solve kernel takes this box window (the row-sharded
    flow, `parallel/spatial.py`, gates its solve on it too)."""
    return winsize <= MAX_KERNEL_WINSIZE


def gauss_solve_takes(winsize: int) -> bool:
    """Whether the gauss_solve kernel takes this Gaussian window: a radius
    winsize // 2 of 1 to 8 (at winsize 1 the plain window's sigma is 0)."""
    return 2 <= winsize <= MAX_KERNEL_WINSIZE


def uses_kernels(params: FarnebackParams) -> bool:
    """Whether `farneback_flow` runs its inner loop through the kernel
    wrappers (the reference's `fused_tpu` gate, `flow/farneback.py:480-485`,
    without the backend test, and open to the Gaussian window, which the
    reference leaves plain: the wrappers pick kernel or plain version by
    the tensors' device)."""
    takes = gauss_solve_takes if params.gaussian_win else box_solve_takes
    return params.warp_mode in ("fast", "fast16") and takes(params.winsize)


def farneback_flow(
    prev_img: torch.Tensor,
    next_img: torch.Tensor,
    params: FarnebackParams = FarnebackParams(),
) -> torch.Tensor:
    """Dense flow for grayscale pairs on their own device: [..., H, W]
    (uint8 or float) → [..., H, W, 2] float32; batched over leading dims.

    Equivalent to cv2.calcOpticalFlowFarneback(prev, next, None, pyr_scale,
    levels, winsize, iterations, poly_n, poly_sigma, flags)."""
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    lead = tuple(prev_img.shape[:-2])
    plan = pyramid_plan(h, w, params)
    prev_f = prev_img.to(torch.float32).reshape(-1, h, w)
    next_f = next_img.to(torch.float32).reshape(-1, h, w)
    fused = uses_kernels(params)
    if fused:
        from opticalflowclustering_tpu_torch.kernels import warp as kw

    def window_solve(m):
        """(fx, fy) of M over the window: a kernel wrapper where `fused`."""
        if not params.gaussian_win:
            return kw.box_solve(m, params.winsize) if fused else _update_flow(m, params.winsize, False)
        with span("ofc.flow.gauss"):
            return kw.gauss_solve(m, params.winsize) if fused else _update_flow(m, params.winsize, True)

    def level_poly(img, h_k, w_k, sigma):
        smooth_sz = pyramid_ksize(sigma)
        with span("ofc.flow.pyramid"):
            if pyramid_kernel_takes(img, smooth_sz, (h, w), (h_k, w_k)):
                from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr

                level = kpyr.pyramid_level(img.contiguous(), smooth_sz, sigma, (h_k, w_k))
            else:
                level = resize_linear(gaussian_blur(img, smooth_sz, sigma, border="reflect101"), (h_k, w_k))
        with span("ofc.flow.poly"):
            return poly_expansion(level, params.poly_n, params.poly_sigma, channel_first=True)

    fx = fy = None
    for k, h_k, w_k, sigma in plan:
        r0, r1 = (level_poly(img, h_k, w_k, sigma) for img in (prev_f, next_f))

        with span("ofc.flow.solve"):
            if fx is None:
                fx = torch.zeros(
                    (r0.shape[0], h_k, w_k), dtype=torch.float32, device=r0.device
                )
                fy = torch.zeros_like(fx)
            else:
                up = resize_linear(torch.stack([fx, fy], dim=1), (h_k, w_k))
                up = up * f32(1.0 / params.pyr_scale)
                fx, fy = up[:, 0].contiguous(), up[:, 1].contiguous()

            if fused:
                # R1's bf16 rounding is iteration-invariant: once per level.
                if params.warp_mode == "fast16":
                    r1 = kw.quantize_r1_fast16(r1)
                m = kw.warp_m(r0, r1, fx, fy)
                for i in range(params.iterations):
                    fx, fy = window_solve(m)
                    if i < params.iterations - 1:
                        m = kw.warp_m(r0, r1, fx, fy)
            else:
                # Level-k flow is in level-k pixels (≈ motion / 2^k): the select
                # warp's radius halves per level, floor 8 (the reference's
                # `flow/farneback.py:536-548`).
                radius_k = max(8, params.warp_radius >> k)
                m = update_matrices(r0, r1, fx, fy, params.warp_mode, radius_k)
                for i in range(params.iterations):
                    fx, fy = window_solve(m)
                    if i < params.iterations - 1:
                        m = update_matrices(r0, r1, fx, fy, params.warp_mode, radius_k)
    return torch.stack([fx, fy], dim=-1).reshape(lead + (h, w, 2))


def resize_linear_flow(flow: torch.Tensor, dst_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear-resize a [..., H, W, 2] flow field (channel-last)."""
    return resize_linear(flow.movedim(-1, -3), dst_hw).movedim(-3, -1)


def farneback_flow_batched(
    gray_frames: torch.Tensor, params: FarnebackParams = FarnebackParams()
) -> torch.Tensor:
    """Flow for every consecutive pair of [N, H, W] frames → [N-1, H, W, 2]."""
    return farneback_flow(gray_frames[:-1], gray_frames[1:], params)
