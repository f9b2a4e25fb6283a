"""Spatial (row) sharding of the Farneback flow (port of
`opticalflowclustering_tpu/parallel/spatial.py`).

Temporal sharding (`parallel/temporal.py`) splits a video between frame
pairs; spatial sharding cuts inside one frame: each device of a `tp` mesh
axis owns a block of rows, and every stage whose output row depends on
neighbouring input rows gets its halo from the adjacent block. One process
issues each block's work in turn, as `parallel/temporal.py` does; CUDA
launches are asynchronous, so blocks on different cards run at the same
time, and a mesh may name the same card several times. The collectives of
the JAX package become plain operations: a halo is the neighbour block's
edge rows copied to the block's device (`ppermute`), the frame's min/max is
taken over the blocks' partial results (`pmin`/`pmax`), the rendered frame
is concatenated on the first block's device (`all_gather`) and the mean
|flow| sums the blocks' partial sums in block order (`psum`).

Per pyramid level k (scale 2^-k, resampled from full resolution like the
unsharded flow and OpenCV):
  1. one full-resolution exchange of F_k rows per side, F_k covering the
     Gaussian presmooth radius, the bilinear downsample support and
     2^k · (poly_n halo + winsize/2 + warp reach). The edge blocks emulate
     the global borders (reflect101 for the blur, replicate downstream), so
     the block-local ops reproduce the unsharded border handling;
  2. blur, downsample and polynomial expansion run on the extended block;
  3. each solver iteration needs a winsize/2-row flow halo, exchanged once
     per iteration; the border taper is built from global row indices, so
     inner blocks apply no vertical taper. The windowed 2×2 solve is
     `kernels.warp.box_solve`: the box_solve CUDA kernel on the card, its
     plain version (`flow.farneback._update_flow`) on the CPU (and for
     windows wider than the kernel's 17, as in `farneback_flow`);
  4. the coarse→fine flow upsample exchanges a 4-row halo and rewrites the
     two globally clamped boundary rows on the edge blocks.

Exactness: while the vertical displacement at level k stays within
`reach_k = max(8, params.warp_radius >> k)` rows (beyond the exchanged halo the
warp applies OpenCV's out-of-image fallback, which the unsharded flow
applies only at the image border), every owned row sees the same float32
operations on the same inputs as the unsharded exact-mode
`flow.farneback.farneback_flow`, and the box_solve kernel is bitwise equal
to its plain version, so the sharded flow is bitwise equal to the unsharded
one. The flow is always the exact warp, whatever `params.warp_mode` says,
and the window is always the box (as in the JAX package).

H must divide by n_shards · 2^levels, so every level splits evenly and the
sample grids of block-local resizes align with the global grid;
`spatial_farneback_flow_padded` replicate-pads the rows of any other H.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
from opticalflowclustering_tpu_torch.flow.farneback import (
    FarnebackParams,
    _border_ramp,
    _m_build,
    _warp_gather,
    poly_expansion,
    pyramid_ksize,
    pyramid_plan,
)
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr_given_range
from opticalflowclustering_tpu_torch.kernels import warp as kw
from opticalflowclustering_tpu_torch.ops.filters import gaussian_blur
from opticalflowclustering_tpu_torch.ops.polar import cart_to_polar
from opticalflowclustering_tpu_torch.ops.resize import resize_linear
from opticalflowclustering_tpu_torch.parallel.mesh import Mesh
from opticalflowclustering_tpu_torch.runtime import f32, resolve_device

# ---------------------------------------------------------------------------
# halo exchange over the blocks (row axis -2)
# ---------------------------------------------------------------------------


def _edge_fill(x: torch.Tensor, n: int, mode: str, side: str) -> torch.Tensor:
    """What padding would put beyond the global border: the stand-in an edge
    block uses for its missing neighbour."""
    size = x.shape[-2]
    if mode == "reflect101":
        sl = x[..., 1 : n + 1, :] if side == "top" else x[..., size - n - 1 : size - 1, :]
        return sl.flip(-2)
    if mode == "zero":
        return x.new_zeros(x.shape[:-2] + (n, x.shape[-1]))
    raise ValueError(mode)


def _extend_rows(blocks: list[torch.Tensor], n: int, mode: str) -> list[torch.Tensor]:
    """Each block with n rows above and below: the neighbour's edge rows,
    copied to the block's device, or the `mode` border emulation at the
    global top and bottom."""
    if n == 0:
        return list(blocks)
    last = len(blocks) - 1
    out = []
    for i, x in enumerate(blocks):
        above = _edge_fill(x, n, mode, "top") if i == 0 else blocks[i - 1][..., -n:, :].to(x.device)
        below = _edge_fill(x, n, mode, "bottom") if i == last else blocks[i + 1][..., :n, :].to(x.device)
        out.append(torch.cat([above, x, below], dim=-2))
    return out


def _slice_rows(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return x[..., lo : x.shape[-2] - hi, :]


def _replicate_edges(x: torch.Tensor, lo: int, n_own: int, top: bool, bottom: bool) -> torch.Tensor:
    """x with the rows before `lo` (on the top block) and from `lo + n_own`
    (on the bottom block) replaced by the nearest owned row: the replicate
    border the unsharded flow's padding sees."""
    lead, w = x.shape[:-2], x.shape[-1]
    if top and lo:
        x = torch.cat([x[..., lo : lo + 1, :].expand(*lead, lo, w), x[..., lo:, :]], dim=-2)
    end = lo + n_own
    if bottom and x.shape[-2] > end:
        x = torch.cat([x[..., :end, :], x[..., end - 1 : end, :].expand(*lead, x.shape[-2] - end, w)], dim=-2)
    return x


# ---------------------------------------------------------------------------
# block-local building blocks
# ---------------------------------------------------------------------------


def _taper_rows(gidx: np.ndarray, total: int) -> np.ndarray:
    """The row ramp of OpenCV's edge taper at global row indices `gidx` of a
    level of `total` rows; 1 beyond the level (those M rows are replaced by
    the edge row)."""
    inside = (gidx >= 0) & (gidx < total)
    return np.where(inside, _border_ramp(total)[np.clip(gidx, 0, total - 1)], np.float32(1.0))


def _update_matrices_ext(
    r0_m: torch.Tensor,
    r1_ext: torch.Tensor,
    dx: torch.Tensor,
    dy: torch.Tensor,
    ext_top: int,
    row0: int,
    h_glob: int,
    taper_m: torch.Tensor,
) -> torch.Tensor:
    """M [B, 5, Hm, W] on a block's M region (owned rows ± winsize/2).

    r0_m, the flow planes dx, dy and taper_m cover the M region; r1_ext
    carries `ext_top` more rows above it (and the warp reach below). `row0`
    is the global row of the region's first row: the bounds test uses
    global rows, so the out-of-image fallback is the unsharded flow's."""
    hm, w = dx.shape[-2], dx.shape[-1]
    dev = dx.device
    ys = (row0 + torch.arange(hm, dtype=torch.int32, device=dev))[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    gx = xs.to(torch.float32) + dx
    gy = ys.to(torch.float32) + dy
    x1 = torch.floor(gx)
    y1 = torch.floor(gy)
    fx = gx - x1
    fy = gy - y1
    x1i = x1.to(torch.int32)
    y1i = y1.to(torch.int32)
    inb = (x1i >= 0) & (x1i <= w - 2) & (y1i >= 0) & (y1i <= h_glob - 2)
    x1c = torch.clamp(x1i, 0, w - 2)
    # global row -> extended-block row, clamped into the exchanged halo
    y1_loc = torch.clamp(y1i - row0 + ext_top, 0, r1_ext.shape[-2] - 2)
    r1w = _warp_gather(r1_ext, y1_loc, x1c, fx, fy)
    return torch.stack(_m_build(r0_m.unbind(-3), r1w.unbind(-3), dx, dy, inb, taper_m), dim=-3)


def _solve_ext(m: torch.Tensor, winsize: int) -> torch.Tensor:
    """The windowed 2×2 solve of a block's M region [B, 5, Hm, W] → flow
    [B, 2, Hm, W], valid on the centre rows: the function of the JAX
    package's `_solve_ext` (a replicate-border box sum over winsize², then
    the regularised solve), through the entry `kernels.warp.box_solve`."""
    fx, fy = kw.box_solve(m.contiguous(), winsize)
    return torch.stack([fx, fy], dim=1)


def _upsample_flow_rows(blocks: list[torch.Tensor], w_dst: int, halo: int = 4) -> list[torch.Tensor]:
    """2× coarse→fine upsample of the blocks' flow [B, 2, h, W]: each block
    takes `halo` coarse rows from its neighbours, is resized (the same
    interpolation weights as the global resize: the grid offset is a
    multiple of the scale) and cut to its own rows; the global first and
    last rows, which the global resize clamps to its edge source rows, are
    rewritten on the edge blocks."""
    ext = _extend_rows(blocks, halo, "zero")
    last = len(blocks) - 1
    out = []
    for i, (x, e) in enumerate(zip(blocks, ext)):
        up = _slice_rows(resize_linear(e, (e.shape[-2] * 2, w_dst)), 2 * halo, 2 * halo)
        top = resize_linear(x[..., :1, :], (1, w_dst)) if i == 0 else up[..., :0, :]
        bottom = resize_linear(x[..., -1:, :], (1, w_dst)) if i == last else up[..., :0, :]
        mid = up[..., top.shape[-2] : up.shape[-2] - bottom.shape[-2], :]
        out.append(torch.cat([top, mid, bottom], dim=-2))
    return out


# ---------------------------------------------------------------------------
# the sharded flow
# ---------------------------------------------------------------------------


def _level_margins(params: FarnebackParams) -> dict[int, tuple[int, int, int]]:
    """Per level k: (warp reach, level margin, full-resolution halo)."""
    out = {}
    mhalf = params.winsize // 2
    for k in range(params.levels + 1):
        reach = max(8, params.warp_radius >> k)
        marg = mhalf + params.poly_n // 2 + reach + 1  # r1 rows the warp reads
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = pyramid_ksize(sigma)
        rb = smooth_sz // 2
        step = 2**k
        full = step * marg + rb + step // 2
        full = ((full + step - 1) // step) * step  # align to the sample grid
        out[k] = (reach, marg, full)
    return out


def _check_shard_geometry(h: int, w: int, n_dev: int, params: FarnebackParams) -> None:
    """The rows must split evenly across the blocks at every pyramid level,
    and a block must be taller than the largest full-resolution halo."""
    if h % (n_dev * 2**params.levels):
        raise ValueError(f"H={h} must divide by n_shards*2^levels={n_dev * 2**params.levels}")
    margins = _level_margins(params)
    max_full = max(margins[k][2] for k, *_ in pyramid_plan(h, w, params))
    if h // n_dev <= max_full:
        raise ValueError(
            f"shard of {h // n_dev} rows too small for the {max_full}-row "
            f"halo (use fewer shards or a smaller warp_radius)"
        )


def _tp_devices(mesh: Mesh, axis_name: str) -> list[torch.device]:
    devs = list(mesh.axis_devices(axis_name))
    for d in set(devs):
        resolve_device(d)  # raises where CUDA is absent; no TF32
    return devs


def _row_blocks(img, devs: list[torch.device]) -> tuple[list[torch.Tensor], tuple]:
    """[..., H, W] → the blocks [B, H/n, W] float32 on their devices, and
    the leading shape."""
    x = torch.as_tensor(img)
    h, w = x.shape[-2], x.shape[-1]
    lead = tuple(x.shape[:-2])
    x = x.reshape(-1, h, w)
    h_loc = h // len(devs)
    return [x[:, i * h_loc : (i + 1) * h_loc].to(d).to(torch.float32) for i, d in enumerate(devs)], lead


def _shard_flow(
    prev_blocks: list[torch.Tensor],
    next_blocks: list[torch.Tensor],
    params: FarnebackParams,
    h: int,
    w: int,
) -> list[torch.Tensor]:
    """The flow of each block's own rows, [B, 2, h_loc, W] on its device."""
    plan = pyramid_plan(h, w, params)
    margins = _level_margins(params)
    mhalf = params.winsize // 2
    n_dev = len(prev_blocks)
    last = n_dev - 1
    h_loc = prev_blocks[0].shape[-2]

    flow = None
    for k, h_k, w_k, sigma in plan:
        step = 2**k
        _, marg, full = margins[k]
        smooth_sz = pyramid_ksize(sigma)
        hk_loc = h_loc // step

        # 1. full-resolution halo, blur, downsample, polynomial expansion
        polys = []
        for blocks in (prev_blocks, next_blocks):
            lvl = []
            for i, ext in enumerate(_extend_rows(blocks, full, "reflect101")):
                sm = gaussian_blur(ext, smooth_sz, sigma, border="reflect101")
                if step > 1:
                    off = full - step * marg
                    ds = resize_linear(_slice_rows(sm, off, off), (hk_loc + 2 * marg, w_k))
                else:
                    off = full - marg
                    ds = _slice_rows(sm, off, off)
                    if w_k != w:
                        ds = resize_linear(ds, (ds.shape[-2], w_k))
                # beyond the global border: the true edge row, as the
                # unsharded expansion's replicate padding sees it
                ds = _replicate_edges(ds, marg, hk_loc, i == 0, i == last)
                lvl.append(poly_expansion(ds, params.poly_n, params.poly_sigma, channel_first=True))
            polys.append(lvl)
        r0_ext, r1_ext = polys

        # the M region: owned rows ± winsize/2 (level rows)
        pad_m = marg - mhalf
        n_m = hk_loc + 2 * mhalf
        r0_m = [r[..., pad_m : pad_m + n_m, :] for r in r0_ext]
        col_ramp = _border_ramp(w_k)
        row0_m, taper_m = [], []
        for i, r in enumerate(r0_m):
            row0_m.append(i * hk_loc - mhalf)
            gidx = row0_m[-1] + np.arange(n_m)
            taper = _taper_rows(gidx, h_k)[:, None] * col_ramp[None, :]
            taper_m.append(torch.from_numpy(taper).to(r.device))

        # 2. initial flow on the M region
        if flow is None:
            flow_m = [r.new_zeros((r.shape[0], 2, n_m, w_k)) for r in r0_m]
        else:
            up = [u * f32(1.0 / params.pyr_scale) for u in _upsample_flow_rows(flow, w_k)]
            flow_m = _extend_rows(up, mhalf, "zero")

        # 3. iterate: M on the region, box solve, exchange the flow halo
        for it in range(params.iterations):
            own = []
            for i in range(n_dev):
                m = _update_matrices_ext(r0_m[i], r1_ext[i], flow_m[i][:, 0], flow_m[i][:, 1], pad_m,
                                         row0_m[i], h_k, taper_m[i])
                # rows beyond the global border replicate the edge M row,
                # as the unsharded box sum's replicate padding does
                m = _replicate_edges(m, mhalf, hk_loc, i == 0, i == last)
                own.append(_slice_rows(_solve_ext(m, params.winsize), mhalf, mhalf))
            if it < params.iterations - 1:
                flow_m = _extend_rows(own, mhalf, "zero")
        flow = own
    return flow


@torch.inference_mode()
def spatial_farneback_flow(
    prev_img,
    next_img,
    mesh: Mesh,
    axis_name: str = "tp",
    params: FarnebackParams = FarnebackParams(),
) -> torch.Tensor:
    """farneback_flow with the row axis sharded over `axis_name`.

    prev_img/next_img: [..., H, W] grayscale (numpy or tensors), H % (n_shards
    · 2^levels) == 0. Returns the [..., H, W, 2] float32 flow on the first
    shard's device, bitwise equal to the unsharded exact-mode flow while the
    motion stays within the reach of `params.warp_radius` (module docstring)."""
    devs = _tp_devices(mesh, axis_name)
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    _check_shard_geometry(h, w, len(devs), params)
    prev_blocks, lead = _row_blocks(prev_img, devs)
    next_blocks, _ = _row_blocks(next_img, devs)
    flow = _shard_flow(prev_blocks, next_blocks, params, h, w)
    out = torch.cat([f.to(devs[0]) for f in flow], dim=-2)
    return out.movedim(1, -1).reshape(lead + (h, w, 2))


def spatial_farneback_flow_padded(
    prev_img,
    next_img,
    mesh: Mesh,
    axis_name: str = "tp",
    params: FarnebackParams = FarnebackParams(),
) -> torch.Tensor:
    """spatial_farneback_flow for any H: the rows are replicate-padded up to
    the next multiple of n_shards · 2^levels and the flow is cropped back.

    Equal to the unsharded exact-mode flow *of the padded frame*, cropped to
    H. Padding moves the bottom image border (taper, blur reflection, box
    windows), so rows near the bottom differ from the unsharded flow of the
    original frame; rows away from it do not."""
    n_dev = mesh.shape[axis_name]
    h = prev_img.shape[-2]
    pad = (-h) % (n_dev * 2**params.levels)
    if pad == 0:
        return spatial_farneback_flow(prev_img, next_img, mesh, axis_name, params)

    def padded(img):
        x = torch.as_tensor(img)
        return torch.cat([x, x[..., h - 1 :, :].expand(*x.shape[:-2], pad, x.shape[-1])], dim=-2)

    flow = spatial_farneback_flow(padded(prev_img), padded(next_img), mesh, axis_name, params)
    return flow[..., :h, :, :]


# ---------------------------------------------------------------------------
# the spatially sharded hue pipeline
# ---------------------------------------------------------------------------


@torch.inference_mode()
def spatial_hue_pipeline(
    prev_img,
    next_img,
    mesh: Mesh,
    axis_name: str = "tp",
    grid: GridParams | None = None,
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """The bounce features of a frame pair with the frame's rows sharded
    over `axis_name`.

    prev_img/next_img: [..., H, W] uint8 grayscale, H divisible by n_shards
    · 2^levels. Returns, on the first shard's device, (hue [..., cells]
    uint8, rgb_hue [..., cells] float32, centroids [..., cells, 4] int32,
    mean_mag [...] float32):

      flow      — row-sharded (`spatial_farneback_flow`'s blocks);
      normalize — the frame's min and max |flow| over the blocks' partial
                  min/max, applied on each block
                  (`render_flow_hsv_bgr_given_range`);
      grid/hue  — the blocks' uint8 renders concatenated on the first
                  shard's device, then the unsharded feature ops.

    The feature tables equal the unsharded pipeline's: the flow is bitwise
    the unsharded one and min/max are exact. mean_mag sums the blocks'
    partial sums in block order (within rtol 1e-6 of the unsharded mean)."""
    grid = GridParams() if grid is None else grid
    devs = _tp_devices(mesh, axis_name)
    h, w = prev_img.shape[-2], prev_img.shape[-1]
    _check_shard_geometry(h, w, len(devs), params)
    prev_blocks, lead = _row_blocks(prev_img, devs)
    next_blocks, _ = _row_blocks(next_img, devs)
    flow = [f.movedim(1, -1) for f in _shard_flow(prev_blocks, next_blocks, params, h, w)]
    mags = [cart_to_polar(f[..., 0], f[..., 1])[0] for f in flow]
    home = devs[0]
    smin = torch.stack([m.amin(dim=(-2, -1), keepdim=True).to(home) for m in mags]).amin(0)
    smax = torch.stack([m.amax(dim=(-2, -1), keepdim=True).to(home) for m in mags]).amax(0)
    bgr = torch.cat([render_flow_hsv_bgr_given_range(f, smin.to(f.device), smax.to(f.device)).to(home)
                     for f in flow], dim=-3)
    centroids, hue = dominant_hue_k1_frames(bgr, grid, rb_swap=rb_swap)
    rgb_hue = grid_mean_hue(bgr, grid)
    total = None
    for m in mags:
        part = m.sum(dim=(-2, -1)).to(home)
        total = part if total is None else total + part
    mean_mag = total * f32(1.0 / (h * w))
    cells = hue.shape[-1]
    return (hue.reshape(lead + (cells,)), rgb_hue.reshape(lead + (cells,)),
            centroids.reshape(lead + (cells, 4)), mean_mag.reshape(lead))
