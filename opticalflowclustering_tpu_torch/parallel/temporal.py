"""Temporal (frame-axis) sharding of the flow pipeline (port of
`opticalflowclustering_tpu/parallel/temporal.py`).

Optical flow couples only adjacent frames (t-1, t): the reference carries
one `prev_gray` frame of state (`computeOpticalFlowModule.py:34`). A video's
N frames therefore split into contiguous blocks across the devices of an
'sp' axis with a one-frame halo: each block gets the next block's first
gray frame, copied to the block's device, computes its local frame pairs,
and every later stage (render, grid pooling, clustering) is local. Videos
split across a 'dp' axis with no exchange at all.

One process issues every block's work in turn; CUDA launches are
asynchronous, so blocks on different cards run at the same time. The ring
wraps, as in the JAX package: the last block pairs its last frame with
frame 0, so row N-1 of each video is a junk pair and callers keep [:N-1].

Every integer table (hue, rgb_hue, centroids) is equal to the unsharded
pipeline's on any mesh, since pairs are independent and every stage after
the flow is per pair; the float mean-magnitude telemetry is held to
rtol 1e-6, because a reduction may choose its order by the batch shape.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.ops.polar import magnitude
from opticalflowclustering_tpu_torch.parallel.mesh import Mesh
from opticalflowclustering_tpu_torch.runtime import resolve_device
from opticalflowclustering_tpu_torch.utils.profiling import span


def _hue_tables(gray_ext: torch.Tensor, grid: GridParams, params: FarnebackParams, rb_swap: bool):
    """[b, n+1, H, W] gray frames → the tables of their n pairs per video:
    (hue [b, n, cells] uint8, rgb_hue [b, n, cells] float32,
    centroids [b, n, cells, 4] int32, mean_mag [b, n] float32)."""
    flow = farneback_flow(gray_ext[:, :-1], gray_ext[:, 1:], params)
    with span("ofc.render"):
        mean_mag = magnitude(flow[..., 0], flow[..., 1]).mean(dim=(-2, -1))
        flow_bgr = render_flow_hsv_bgr(flow)
    with span("ofc.grid"):
        centroids, hue = dominant_hue_k1_frames(flow_bgr, grid, rb_swap=rb_swap)
        return hue, grid_mean_hue(flow_bgr, grid), centroids, mean_mag


def _split(size: int, parts: int, what: str) -> int:
    if size % parts:
        raise ValueError(f"{what} of {size} does not divide by the axis size {parts}")
    return size // parts


def _block_grays(videos, devs: np.ndarray):
    """The (dp, sp) blocks of videos [B, N, H, W, 3] u8 over devs [dp, sp]:
    yields (i, j, gray_ext) with gray_ext the block's gray frames
    [b_loc, n_loc + 1, H, W] on devs[i, j], the next block's first frame (the
    ring wraps: the last block gets frame 0) appended as the one-frame halo."""
    for d in set(devs.flat):
        resolve_device(d)  # raises where CUDA is absent; no TF32
    v = torch.as_tensor(videos)
    dp, sp = devs.shape
    b_loc = _split(v.shape[0], dp, "a batch")
    n_loc = _split(v.shape[1], sp, "a frame axis")
    gray = [[None] * sp for _ in range(dp)]
    for i in range(dp):
        for j in range(sp):
            with span("ofc.upload"):
                block = v[i * b_loc : (i + 1) * b_loc, j * n_loc : (j + 1) * n_loc].to(devs[i, j])
            with span("ofc.render"):
                gray[i][j] = bgr2gray(block)
    for i in range(dp):
        for j in range(sp):
            with span("ofc.halo"):
                gray_ext = torch.cat([gray[i][j], gray[i][(j + 1) % sp][:, :1].to(devs[i, j])], dim=1)
            yield i, j, gray_ext


def _sharded_blocks(videos, devs: np.ndarray, step):
    """Run `step(gray_ext)` on every (dp, sp) block of videos [B, N, H, W, 3]
    u8 on the block's device of devs [dp, sp] (`_block_grays`). Returns each
    output of `step` stitched back to [B, N, ...] on the CPU."""
    dp, sp = devs.shape
    outs = [[None] * sp for _ in range(dp)]
    for i, j, gray_ext in _block_grays(videos, devs):
        outs[i][j] = step(gray_ext)
    n_out = len(outs[0][0])
    with span("ofc.readback"):
        return tuple(
            torch.cat([torch.cat([outs[i][j][t].cpu() for j in range(sp)], dim=1) for i in range(dp)])
            for t in range(n_out)
        )


@torch.inference_mode()
def temporal_shard_flow(
    frames,
    mesh: Mesh,
    axis_name: str = "sp",
    params: FarnebackParams = FarnebackParams(),
) -> torch.Tensor:
    """Flow over a frame-sharded video: [N, H, W, 3] u8 → [N, H, W, 2] on the
    CPU (row N-1 is the wrapped junk pair; drop it). N must divide by the
    axis size."""
    devs = mesh.axis_devices(axis_name)[None, :]
    (flow,) = _sharded_blocks(
        torch.as_tensor(frames)[None], devs,
        lambda g: (farneback_flow(g[:, :-1], g[:, 1:], params),),
    )
    return flow[0]


@torch.inference_mode()
def sharded_hue_pipeline(
    frames,
    mesh: Mesh,
    axis_name: str = "sp",
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """flow → render → grid → cluster with one video's frame axis sharded
    across `axis_name`: [N, H, W, 3] u8 → (hue [N, cells], rgb_hue [N, cells],
    mean_mag [N]) on the CPU; the last row of each is the wrapped junk pair.
    Beyond the one-frame halo every stage is local to its device."""
    devs = mesh.axis_devices(axis_name)[None, :]
    hue, rgb_hue, _, mean_mag = _sharded_blocks(
        torch.as_tensor(frames)[None], devs,
        lambda g: _hue_tables(g, grid, params, rb_swap),
    )
    return hue[0], rgb_hue[0], mean_mag[0]


@torch.inference_mode()
def sharded_hue_pipeline_videos(
    videos,
    mesh: Mesh,
    dp_axis: str = "dp",
    sp_axis: str = "sp",
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
):
    """dp×sp-sharded pipeline over a batch of videos [B, N, H, W, 3] u8:
    videos split across `dp_axis`, each video's frames across `sp_axis`
    (one-frame ring halo). Returns, on the CPU, (hue [B, N, cells] uint8,
    rgb_hue [B, N, cells] float32, centroids [B, N, cells, 4] int32 RGBA,
    the per-cell addnew rows of `KmeanGrids.py:320-339`, mean_mag [B, N]
    float32); row N-1 of each video is the wrapped junk pair (its last frame
    against frame 0), so valid data is [:, :N-1]. B must divide by the dp
    size and N by the sp size."""
    devs = mesh.axis_devices(dp_axis, sp_axis)
    return _sharded_blocks(videos, devs, lambda g: _hue_tables(g, grid, params, rb_swap))


@torch.inference_mode()
def unsharded_hue_pipeline_videos(
    videos,
    grid: GridParams = GridParams(),
    params: FarnebackParams = FarnebackParams(),
    rb_swap: bool = True,
    device: str | torch.device = "cuda",
):
    """One-device emulation of sharded_hue_pipeline_videos (the same ops, the
    same ring wrap, the same 4-tuple, on `device`): the oracle of the
    mesh-invariance checks."""
    gray = bgr2gray(torch.as_tensor(videos).to(resolve_device(device)))
    return _hue_tables(torch.cat([gray, gray[:, :1]], dim=1), grid, params, rb_swap)
