#!/usr/bin/env python3
"""Smoke test of the PyTorch port (opticalflowclustering_tpu_torch) on one
CUDA card: builds the port's kernels (warp+M, box-solve, Gaussian-solve,
the polynomial expansion and the gather-cost probes) from the sources in
the checkout,
holds each against its plain PyTorch version on the card (box-solve bit for
bit at every odd winsize up to 17, on the 720p pyramid's level shapes and on
small frames), runs the probe scripts (gather_cost_probe, profile_r4) at
their full sizes, holds the polynomial expansion bit for bit at every level
shape of the 720p and the cropped clip's pyramids and times it beside its
bound, holds the Gaussian-window solve bit for bit at every radius 1-8 on
the 5-level 720p pyramid's shapes and on small and odd-width frames, times
it beside its bound and runs process_frames at OpenCV's accurate Farneback
settings with its launches counted, drives the bounce-feature
pipeline (process_frames) at 1280x720 with both kernel warp modes and every
kernel's launches counted, checks it against the same pipeline on CPU
tensors, matches a bounce signature, then drives the video-file paths at 1280x720 with their kernel
launches counted: the stream's device loop through its prefetch thread
(tables equal to process_frames'), the sequential and the dp×sp queue on a
2×2 mesh of the card (artifacts equal), the temporal split (equal to the
unsharded pipeline) and the findcosine CLI; the native MJPEG decoder
(built from the checkout's C++ source with g++ alone) on the clip written
as an MJPG AVI and on demo_out/601_3.avi (bitwise equal at 1 thread and at
every core, the demo clip equal to the JAX package's libjpeg decode by a
pinned digest, within 5 codes of cv2's), its stream with its launches and
the frames through each decoder counted (tables equal to process_frames'
of the natively decoded frames), and decode frames/s and stream pairs/s
beside cv2's; then flow EPE against
cv2.calcOpticalFlowFarneback in every warp mode, the drawgrids CLI
(against itself on the CPU), the kmeangrids cell-tree path over drawgrids'
16,800 cell PNGs (equal to grid_cluster_stage) and the vectordistance CLI;
kmeangrids with its default flags (YOLO/contour overlays drawn on the card,
its table equal to grid_cluster_stage over overlays drawn on the host, its
launches counted) and the ops/ modules (Canny, morphology, histograms,
warps, SSIM, Hough, SLIC) against the CPU with the detectcircles and
superpixels CLIs; the row-sharded (spatial) Farneback flow on a tp=2 and a
tp=4 mesh of the card with box_solve on every block (its tables equal to the
unsharded pipeline's, its launches counted), the dryrun entry's six passes
and its forward step, and the extras (scan and searchengine CLIs,
color_transfer, skin_mask, locate_barcode, brightest_spot, find_screen with
a Zernike descriptor) against the CPU; the legacy 'select' warp (plain
PyTorch, no warp_m or box_solve launched) against the CPU on the 720p clip and on
demo_out/601_3.avi, its EPE against exact and cv2, and process_frames'
pairs/s and peak memory in 'select' beside 'fast'; then the clustering and model
paths at 1280x720, each against the same function on the CPU: kmeans_batched
over the 16,800 cells of the rendered flow frames, quantize_colors, the
colorkmeans CLI, FlowCellNet serving (detect_windows on every frame, the
classify, detect and realtime CLIs), SmallCNN, the trainbounce CLI, and the
fused dp×sp train step on a 2×2 and a 1×1 mesh of the card with its kernel
launches counted; and times the pipeline, the stream, the queues, the model
paths and each kernel, the pipeline kernels at each pyramid level beside
their bounds (the least time the card could take: bytes over the HBM rate
or operations over the float32 rate).

    python3 chip_smoke.py

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails. On success the line before the last is a JSON object with one
entry per kernel, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch and numpy only (no JAX). Where cv2 is importable it also
decodes demo_out/601_3.avi through the cv2 stream and feeds the queue from
MJPG files; where it is not, the frames come from memory through the same
prefetch thread and a stand-in for the queue's decoder.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import sys
import time

import numpy as np

from opticalflowclustering_tpu_torch import kernels
from opticalflowclustering_tpu_torch.scripts.clips import noise_frames, synth_frames
from opticalflowclustering_tpu_torch.utils.profiling import card_line

H, W, N = 720, 1280, 49
CROP_HW = (232, 220)  # demo_out/601_3.avi's frame: the cropped clip's pyramid levels
REPEATS = 3
# Trip counts of the probes' bitwise checks (the plain loops run in Python):
# 0 to 2U + 1 for U = probes.UNROLL = 16, so every n mod U and a group more,
# then 256 and one above 1,000.
PROBE_CHECK_N = tuple(range(34)) + (256, 1031)
PLAIN_SLOPE_N = (64, 256)  # trip counts of the plain loops' per-iteration slope
# box_solve's bitwise check: every odd winsize the kernel takes, on the
# pyramid's level shapes and on these, whose windows are wider than the
# frame or whose widths are no multiple of 4.
BOX_WINSIZES = tuple(range(1, 18, 2))
BOX_SHAPES = ((2, 72, 300), (3, 40, 100), (1, 5, 7), (1, 3, 40))
POLY_CHECK = ((3, 0.9), (5, 1.2), (7, 1.5))  # (poly_n, poly_sigma) of the poly kernel's bitwise check
GAUSS_WINSIZES = tuple(range(3, 18, 2))  # the Gaussian solve's radius 1..8
GAUSS_SHAPES = ((2, 37, 133), (3, 19, 130), (1, 5, 7), (1, 3, 40))  # odd widths, frames below the window
# OpenCV's accurate settings: FarnebackOpticalFlow::create's 5 levels,
# winsize 13 and 10 iterations, poly_n 7 / poly_sigma 1.5 and the Gaussian
# window (the bounce720-gauss benchmark configuration).
ACCURATE = dict(pyr_scale=0.5, levels=5, winsize=13, iterations=10, poly_n=7, poly_sigma=1.5, gaussian_win=True)
QUEUE_CLIP = 17  # frames per queue clip: 16 pairs, one chunk each
DEMO_FRAMES = None  # frames of demo_out/601_3.avi the cv2 stream check reads (None: all)
# --max-frames of drawgrids' CPU run: 2 pairs of plain 720p flow on the host
# take ~20 s, so the check reads the card's first 2 rows.
DRAWGRIDS_CPU_FRAMES = 3
REALTIME_FRAMES = 75  # --max-frames of the realtime CLI on demo_out/601_3.avi
SPATIAL_PAIRS = 4  # pairs of the clip the row-sharded flow runs on
OPS_CMP_HW = (360, 640)  # Hough and SLIC card vs CPU at this size (the CPU side is slow at 720p)
SELECT_CARD_CPU_EPE = 1e-3  # px, mean: the 'select' flow on the card vs the CPU (phase 4's bound)
# sha256 of the JAX package's native (libjpeg-turbo) decode of
# demo_out/601_3.avi, which the port's decoder reproduces (pinned also by
# tests/test_torch_fastio.py).
DEMO_NATIVE_SHA256 = "8211c98448d3e3118b9fe63779819b6f1e6e79aa5f1e188ae8c5d07e405a627e"
# cv2's JPEG quality of the native phase's clip re-encoded baseline and
# progressive (4:2:0 both).
REENCODE_QUALITY = 90
# The committed arithmetic-coded frames (made by make_fixtures.py there):
# frames 29 and 30 of demo_out/601_3.avi tiled to 1280x720, each as cv2's
# baseline JPEG at quality 90 4:2:0 (<tile>.jpg) and its coefficients
# re-coded sequential (.sof9.jpg) and progressive (.sof10.jpg).
ARITH_GOLDEN = os.path.join("tests", "golden", "torch_arith")
ARITH_TILES = ("demo29_720p_q90", "demo30_720p_q90")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_hues(got, want, saturation, tag, min_exact=0.97) -> float:
    """The repo's real-footage hue invariant (tests/test_real_footage_e2e.py
    `_check_hues`): > min_exact of cells equal, and every disagreement beyond
    ±2 circular hue steps in a low-saturation cell (spread ≤ 16)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    exact = float((got == want).mean())
    d = np.abs(got - want)
    d = np.minimum(d, 180 - d)
    check(exact > min_exact, f"{tag}: exact share {exact}")
    worst = float(np.asarray(saturation)[d > 2.0].max(initial=0.0))
    check(worst <= 16, f"{tag}: disagreement in a cell of saturation {worst}")
    return exact


def cell_means(bgr: np.ndarray, rows=14, cols=25) -> np.ndarray:
    h, w = bgr.shape[-3:-1]
    ys, xs = h // rows, w // cols
    crop = bgr[..., : rows * ys, : cols * xs, :].astype(np.float64)
    return crop.reshape(crop.shape[:-3] + (rows, ys, cols, xs, 3)).mean(axis=(-4, -2))


def sat(colours) -> np.ndarray:
    c = np.asarray(colours)[..., :3].astype(np.int32)
    return (c.max(-1) - c.min(-1)).astype(np.float32)


def probe_phase(dev, stamp: str) -> list[dict]:
    """Phase 3b: the four gather-cost probe kernels. Holds each against its
    plain version on the card (bitwise, at every trip count of
    PROBE_CHECK_N), times the plain loops per iteration, then runs the probe
    scripts at their full sizes with every launch count set to 0 just
    before, and checks that each probe kernel (and warp_m, box_solve through
    profile_r4's D) launched. Prints each body's time beside its three
    bounds (ALU, acc chain, shared memory) and this tile's bank conflicts,
    and dynslice's graph-replay time beside its launch floor. Returns the
    kernels' entries of the results line."""
    import torch

    from opticalflowclustering_tpu_torch.kernels import probes
    from opticalflowclustering_tpu_torch.scripts import gather_cost_probe as gcp
    from opticalflowclustering_tpu_torch.scripts import profile_r4 as pr4
    from opticalflowclustering_tpu_torch.utils import profiling

    def tile(body):
        return gcp.tile(dev, torch.bfloat16 if body == "take_bf16" else torch.float32)

    err = {"loop_probe": 0.0, "dynslice": 0.0}
    for body in probes.BODIES:
        x, idx = tile(body)
        for n in PROBE_CHECK_N:
            got = probes.loop_probe(body, x, idx, n)
            want = probes.loop_probe_reference(body, x, idx, n)
            e = (got - want).abs().max().item()
            err["loop_probe"] = max(err["loop_probe"], e)
            check(torch.equal(got, want), f"loop_probe {body} n={n}: not bitwise, max abs err {e}")
        print(f"check loop_probe {body} [80,128] n={PROBE_CHECK_N}: bitwise equal to the plain version")
    xb, _ = tile("take_bf16")
    for off in range(-8, 16):
        o = torch.tensor([off], dtype=torch.int32, device=dev)
        got, want = probes.dynslice(xb, o), probes.dynslice_reference(xb, o)
        err["dynslice"] = max(err["dynslice"], (got - want).abs().max().item())
        check(torch.equal(got, want), f"dynslice off={off}: not bitwise")
    one = torch.tensor([1], dtype=torch.int32, device=dev)
    check(torch.equal(probes.dynslice(xb, one), xb[8:32].float()), "dynslice off=1 is not x[8:32]")
    print("check dynslice off -8..15: bitwise equal to the plain version; off=1 gives x[8:32]")

    # The plain loops per iteration, by the slope between two small n.
    plain_ns = {}
    for body in probes.BODIES:
        x, idx = tile(body)
        plain_ns[body] = 1e6 * profiling.slope_ms(
            lambda n, b=body, x=x, idx=idx: functools.partial(probes.loop_probe_reference, b, x, idx, n),
            *PLAIN_SLOPE_N, repeats=3)
    x, idx = tile("take")
    n_ms = PLAIN_SLOPE_N[-1]
    take_ms = profiling.graph_ms(lambda: probes.loop_probe("take", x, idx, n_ms), gcp.GRAPH_LAUNCHES)
    take_plain_ms = profiling.event_ms(lambda: probes.loop_probe_reference("take", x, idx, n_ms), 3)
    dyn_plain_ms = profiling.event_ms(lambda: probes.dynslice_reference(xb, one))
    take_bound, take_by = profiling.bound_ms(*probes.loop_probe_cost("take", x.shape[0], n_ms))
    dyn_bound, dyn_by = profiling.bound_ms(*probes.dynslice_cost())

    # The probe path: both scripts at their full sizes.
    kernels.reset_launches()
    g = gcp.run_all(dev, stamp)
    r = pr4.run_all(dev, stamp)
    launches = {k: kernels.LAUNCHES[k] for k in ("loop_probe", "dynslice")}
    warp_launches = kernels.flow_launches()
    print(f"probe path: launches {launches}, {warp_launches} (a call captured into a CUDA graph counts once)")
    check(all(v > 0 for v in launches.values()), f"a probe kernel was not launched: {launches}")
    check(warp_launches["warp_m"] > 0 and warp_launches["box_solve"] > 0,
          f"profile_r4 D launched no warp kernel: {warp_launches}")

    kern_ns = dict(g["f32"], take_bf16=g["take_bf16"], two_takes=r["two_takes_ns"],
                   packed_take_unpack=r["packed_ns"])
    gcp_src, r4_src = "scripts/gather_cost_probe.py", "scripts/profile_r4.py"
    replaces = {"mul": f"{gcp_src}:34", "where": f"{gcp_src}:34", "take": f"{gcp_src}:34",
                "take_bf16": f"{gcp_src}:94", "two_takes": f"{r4_src}:72",
                "packed_take_unpack": f"{r4_src}:72"}
    sm, max_sm = profiling.sm_clocks_mhz()
    idx_cpu = gcp.tile("cpu")[1]  # the probes' idx, as the scripts make it
    bodies = {}
    for body in probes.BODIES:
        k = kern_ns[body]
        b = probes.loop_probe_bounds_ns(body, x.shape[0], max_sm)
        busiest, per_warp = probes.gather_wavefronts(body, idx_cpu)
        floor_ns = busiest / max_sm * 1e3
        bodies[body] = {"replaces": replaces[body], "ns_per_iter": k, "plain_ns_per_iter": plain_ns[body],
                        "bound_ns_per_iter": max(b.values()), "alu_bound_ns": b["alu"],
                        "chain_bound_ns": b["chain"], "smem_bound_ns": b["smem"],
                        "busiest_row_wavefronts": busiest, "gather_wavefronts_per_warp": per_warp,
                        "busiest_row_ns": floor_ns}
        shares = ", ".join(f"{name} {v:.3f} ({v / k:.1%})" for name, v in
                           (("ALU", b["alu"]), ("acc chain", b["chain"]), ("shared memory", b["smem"])))
        print(f"time loop_probe {body} [80,128]: kernel {k:.3f} ns/iter, plain {plain_ns[body]:.1f} ns/iter; "
              f"bounds {shares} ns/iter, the largest {max(b.values()):.3f} "
              f"({max(b.values()) / k:.1%}), at {max_sm:.0f} MHz (clocks.max.sm; clocks.sm {sm:.0f} MHz now) "
              f"(CUDA events, slopes) {stamp}")
        if busiest:
            print(f"bank conflicts loop_probe {body}: the seed-0 idx's busiest row needs {busiest} wavefronts an "
                  f"iteration, stores included ({floor_ns:.3f} ns on its SM at {max_sm:.0f} MHz, {floor_ns / k:.1%} "
                  f"of the kernel's time); a warp's gather {per_warp:.2f} wavefronts on average")
    dyn = g["dynslice"]
    print(f"time loop_probe take n={n_ms}: kernel {take_ms:.4f} ms (CUDA graph replay), plain {take_plain_ms:.4f} "
          f"ms, bound {take_bound:.6f} ms ({take_by}) {stamp}")
    print(f"time dynslice: kernel {dyn['ms']:.6f} ms (CUDA graph replay), launch floor {dyn['floor_ms']:.6f} ms, "
          f"host-inclusive call {dyn['host_ms']:.4f} ms, plain {dyn_plain_ms:.4f} ms, bound {dyn_bound:.7f} ms "
          f"({dyn_by}; {dyn_bound / dyn['ms']:.2%}); the floor is {dyn['floor_ms'] / dyn['ms']:.1%} of the "
          f"kernel's time {stamp}")
    src = "opticalflowclustering_tpu_torch/kernels/csrc/probes.cu"
    return [
        {"name": "loop_probe", "route": "cuda", "source": src,
         "replaces": f"{gcp_src}:34, {gcp_src}:94, {r4_src}:72",
         "launches": launches["loop_probe"], "max_abs_err": err["loop_probe"],
         "ms": take_ms, "plain_ms": take_plain_ms, "bound_ms": take_bound, "bound_by": take_by,
         "library_ms": None, "ms_of": f"take, n={n_ms}, CUDA graph replay", "bodies": bodies,
         "design": f"one block of 128 threads per row (80 blocks, one wave); stage groups of {probes.UNROLL} "
                   f"iterations: the fresh rows stored to one shared-memory buffer each behind one barrier, "
                   f"gathered back to back, added to acc after the next group's gathers; two buffer sets; a "
                   f"float counter and packed bf16 conversions, no conversion per element"},
        {"name": "dynslice", "route": "cuda", "source": src, "replaces": f"{gcp_src}:133",
         "launches": launches["dynslice"], "max_abs_err": err["dynslice"],
         "ms": dyn["ms"], "plain_ms": dyn_plain_ms, "bound_ms": dyn_bound, "bound_by": dyn_by,
         "library_ms": None, "ms_of": "CUDA graph replay", "launch_floor_ms": dyn["floor_ms"],
         "host_ms": dyn["host_ms"],
         "design": "one block of 384 threads; the 24-row window alone, one 16-byte load of 8 bf16 and two "
                   "16-byte stores a thread; no shared memory, no barrier"},
    ]


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def kernel_runs(n_pairs: int, chunk: int, h: int, w: int, params) -> int:
    """Launches of each pipeline kernel that `process_frames` makes for
    n_pairs pairs of h×w: one farneback_flow per chunk, and one launch per
    pyramid level and iteration in each."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan

    return -(-n_pairs // chunk) * len(pyramid_plan(h, w, params)) * params.iterations


def poly_runs(n_pairs: int, chunk: int, h: int, w: int, params) -> int:
    """Launches of the poly-expansion kernel that `process_frames` makes for
    n_pairs pairs of h×w: one per pyramid level and image of each chunk."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan

    return -(-n_pairs // chunk) * len(pyramid_plan(h, w, params)) * 2


def pyramid_runs(n_pairs: int, chunk: int, h: int, w: int, params) -> int:
    """Launches of the pyramid kernel that `process_frames` makes for
    n_pairs pairs of h×w: one per pyramid level it takes (`pyramid_takes`)
    and image of each chunk."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_ksize, pyramid_plan
    from opticalflowclustering_tpu_torch.kernels.pyramid import pyramid_takes

    levels = sum(pyramid_takes(pyramid_ksize(s), (h, w), (h_k, w_k))
                 for _, h_k, w_k, s in pyramid_plan(h, w, params))
    return -(-n_pairs // chunk) * levels * 2


def flow_runs(n_pairs: int, chunk: int, h: int, w: int, params, calls: int = 1) -> dict:
    """Launches of each flow kernel that `calls` runs of `process_frames`
    make over n_pairs pairs of h×w: warp_m and the window's solve (box_solve,
    or gauss_solve for the Gaussian window) `kernel_runs` each in the warp
    modes that take them ('fast', 'fast16'), none in the others; the poly
    expansion `poly_runs` and the pyramid `pyramid_runs` in every mode."""
    warp = calls * kernel_runs(n_pairs, chunk, h, w, params) if params.warp_mode in ("fast", "fast16") else 0
    return {"warp_m": warp, "box_solve": 0 if params.gaussian_win else warp,
            "gauss_solve": warp if params.gaussian_win else 0,
            "poly_expansion": calls * poly_runs(n_pairs, chunk, h, w, params),
            "pyramid": calls * pyramid_runs(n_pairs, chunk, h, w, params)}


def add_runs(*runs: dict) -> dict:
    """The sum of launch counts by kernel."""
    return {k: sum(r[k] for r in runs) for k in kernels.FLOW_KERNELS}


def loop_ms(fn, iters: int) -> float:
    """Mean ms of one of `iters` back-to-back calls of fn between two CUDA
    events, after 3 calls of warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / iters


def poly_phase(dev, stamp: str, levels, params, check_levels=()) -> dict:
    """Phase 3c: the poly-expansion kernel bit for bit its plain version
    (int32 views, so signed zeros count) at every shape of `levels` and
    `check_levels`, for each (n, sigma) of POLY_CHECK, on integer frames
    laced with -0.0 and subnormals; then its time at each of `levels`
    (finest first) beside its bound (24 bytes a pixel over the HBM rate), at
    the finest in turns with the plain version's (plain, kernel, kernel,
    plain), and a chunk's 2 launches a level summed. Returns the finest
    level's times and the largest |kernel - plain| measured."""
    import torch

    from opticalflowclustering_tpu_torch.kernels import poly as kp
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    gen = torch.Generator(device=dev).manual_seed(3)
    n, sigma = params.poly_n, params.poly_sigma
    finest, chunk_ms, chunk_bound, err = None, 0.0, 0.0, 0.0
    for i, (b, h, w) in enumerate(list(levels) + list(check_levels)):
        x = torch.randint(0, 256, (b, h, w), generator=gen, device=dev).float()
        x[..., ::7, ::5] = -0.0
        x[..., 3::11, ::3] = 1e-40
        for pn, ps in POLY_CHECK:
            got = kp.poly_expansion_cuda(x, pn, ps)
            want = kp.poly_expansion_reference(x, pn, ps)
            sync(dev)
            off = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            err = max(err, float((got - want).abs().max()))
            check(off == 0, f"poly_expansion n={pn} [{b},{h},{w}]: {off} values differ in their bits")
        del got, want
        print(f"check poly_expansion n={', '.join(str(pn) for pn, _ in POLY_CHECK)} [{b},{h},{w}]: "
              f"bitwise equal to the plain version")
        if i >= len(levels):
            continue
        bound, by = bound_ms(kp.kernel_bytes(b, h, w), kp.kernel_ops(n, b, h, w))
        kern = lambda: kp.poly_expansion_cuda(x, n, sigma)  # noqa: E731
        order = ""
        if finest is None:
            plain = lambda: kp.poly_expansion_reference(x, n, sigma)  # noqa: E731
            p1, k1, k2, p2 = loop_ms(plain, 10), loop_ms(kern, 50), loop_ms(kern, 50), loop_ms(plain, 10)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            finest = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            order = f", plain {plain_ms:.4f} ms (order plain, kernel, kernel, plain)"
        else:
            ms = loop_ms(kern, 50)
        chunk_ms, chunk_bound = chunk_ms + 2 * ms, chunk_bound + 2 * bound
        print(f"time poly_expansion [{b},{h},{w}] n={n}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of the bound{order} (CUDA events) {stamp}")
    print(f"time poly_expansion per 16-pair chunk ({len(levels)} levels x 2 images = {2 * len(levels)} launches): "
          f"{chunk_ms:.4f} ms, bound {chunk_bound:.4f} ms, {chunk_bound / chunk_ms:.1%} of the bound {stamp}")
    return {**finest, "max_abs_err": err}


def pyramid_phase(dev, stamp: str, configs) -> dict:
    """Phase 3e: the pyramid kernel bit for bit its plain version (int32
    views, so signed zeros count) at every level of each configuration of
    `configs` ([(name, b, h, w, params)]), on integer frames laced with
    -0.0 and subnormals; then each level's launch timed beside its bound
    (the frames read and the level written once, over the HBM rate), and a
    chunk's levels, 2 images each, in turns with the plain stage (plain,
    kernel, kernel, plain). Returns per configuration the chunk's times and
    bound and the largest |kernel - plain| measured."""
    import torch

    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_ksize, pyramid_plan
    from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    gen = torch.Generator(device=dev).manual_seed(5)
    res = {}
    for name, b, h, w, params in configs:
        x = torch.randint(0, 256, (b, h, w), generator=gen, device=dev).float()
        x[..., ::7, ::5] = -0.0
        x[..., 3::11, ::3] = 1e-40
        levels = [(pyramid_ksize(s), s, (h_k, w_k)) for _, h_k, w_k, s in pyramid_plan(h, w, params)]
        err = 0.0
        for ks, s, hw in levels:
            got = kpyr.pyramid_cuda(x, ks, s, hw)
            want = kpyr.pyramid_reference(x, ks, s, hw)
            sync(dev)
            off = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            err = max(err, float((got - want).abs().max()))
            check(off == 0, f"pyramid {name} [{b},{h},{w}] to {hw[0]}x{hw[1]} ksize {ks}: "
                            f"{off} values differ in their bits")
        del got, want
        print(f"check pyramid {name} [{b},{h},{w}] to "
              f"{', '.join(f'{hh}x{ww} (ksize {ks})' for ks, _, (hh, ww) in levels)}: "
              f"bitwise equal to the plain version, max_abs_err {err}")
        for ks, s, hw in levels:
            lb, lby = bound_ms(kpyr.kernel_bytes(b, h, w, *hw), kpyr.kernel_ops(ks, b, h, w, *hw))
            ms = loop_ms(lambda ks=ks, s=s, hw=hw: kpyr.pyramid_cuda(x, ks, s, hw), 50)
            print(f"time pyramid {name} [{b},{h},{w}] to {hw[0]}x{hw[1]} ksize {ks}: kernel {ms:.4f} ms, "
                  f"bound {lb:.4f} ms ({lby}), {lb / ms:.1%} of the bound (CUDA events) {stamp}")

        def chunk(fn):
            def run():
                for _ in range(2):
                    for ks, s, hw in levels:
                        fn(x, ks, s, hw)
            return run

        bound, by = bound_ms(2 * sum(kpyr.kernel_bytes(b, h, w, *hw) for _, _, hw in levels),
                             2 * sum(kpyr.kernel_ops(ks, b, h, w, *hw) for ks, _, hw in levels))
        kern, plain = chunk(kpyr.pyramid_cuda), chunk(kpyr.pyramid_reference)
        p1, k1, k2, p2 = loop_ms(plain, 3), loop_ms(kern, 20), loop_ms(kern, 20), loop_ms(plain, 3)
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"time pyramid {name} per 16-pair chunk ({len(levels)} levels x 2 images = {2 * len(levels)} "
              f"launches): kernel {ms:.4f} ms, bound {bound:.4f} ms, {bound / ms:.1%} of the bound; plain "
              f"{plain_ms:.4f} ms, {plain_ms / ms:.1f}x the kernel (order plain, kernel, kernel, plain) "
              f"(CUDA events) {stamp}")
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "max_abs_err": err}
    return res


def gauss_phase(dev, stamp: str, levels, params, frames, check_shapes=()) -> dict:
    """Phase 3d: the Gaussian-solve kernel bit for bit its plain version
    (int32 views, so signed zeros count) at every shape of `levels` and
    `check_shapes`, for each winsize of GAUSS_WINSIZES, on a random M laced
    with -0.0 and subnormals; then its time at each of `levels` (finest
    first) at `params.winsize` beside its bound (28 bytes a pixel over the
    HBM rate), at the finest in turns with the plain version's (plain,
    kernel, kernel, plain), and a chunk's `iterations` launches a level
    summed; then `process_frames` over `frames` at `params` with its
    launches counted. Returns the finest level's times, the largest
    |kernel - plain| measured and the pipeline's launches."""
    import torch

    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    gen = torch.Generator(device=dev).manual_seed(4)
    ws = params.winsize
    finest, chunk_ms, chunk_bound, err = None, 0.0, 0.0, 0.0
    for i, (b, h, w) in enumerate(list(levels) + list(check_shapes)):
        m = torch.randn(b, 5, h, w, generator=gen, device=dev) * 10
        m[:, 0].abs_()
        m[:, 2].abs_()
        m[..., ::7, ::5] = -0.0
        m[:, 3, 3::11, ::3] = 1e-40
        for k in GAUSS_WINSIZES:
            got = kw.gauss_solve(m, k)
            want = kw.gauss_solve_reference(m, k)
            sync(dev)
            off = sum(int((g.view(torch.int32) != v.view(torch.int32)).sum()) for g, v in zip(got, want))
            err = max([err] + [float((g - v).abs().max()) for g, v in zip(got, want)])
            check(off == 0, f"gauss_solve winsize {k} [{b},5,{h},{w}]: {off} values differ in their bits")
        del got, want
        print(f"check gauss_solve winsize {GAUSS_WINSIZES[0]}..{GAUSS_WINSIZES[-1]} (odd) [{b},5,{h},{w}]: "
              f"bitwise equal to the plain version")
        if i >= len(levels):
            continue
        bound, by = bound_ms(kw.kernel_bytes("gauss_solve", b, h, w), kw.kernel_ops("gauss_solve", b, h, w, ws))
        kern = lambda: kw.gauss_solve(m, ws)  # noqa: E731
        order = ""
        if finest is None:
            plain = lambda: kw.gauss_solve_reference(m, ws)  # noqa: E731
            p1, k1, k2, p2 = loop_ms(plain, 10), loop_ms(kern, 50), loop_ms(kern, 50), loop_ms(plain, 10)
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            finest = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
            order = f", plain {plain_ms:.4f} ms (order plain, kernel, kernel, plain)"
        else:
            ms = loop_ms(kern, 50)
        chunk_ms += params.iterations * ms
        chunk_bound += params.iterations * bound
        print(f"time gauss_solve [{b},5,{h},{w}] winsize {ws}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
              f"{bound / ms:.1%} of the bound{order} (CUDA events) {stamp}")
    print(f"time gauss_solve per 16-pair chunk ({len(levels)} levels x {params.iterations} iterations = "
          f"{len(levels) * params.iterations} launches): {chunk_ms:.4f} ms, bound {chunk_bound:.4f} ms, "
          f"{chunk_bound / chunk_ms:.1%} of the bound {stamp}")

    n, h, w = frames.shape[:3]
    cfg = PipelineConfig(emit_flow_bgr=False, flow=params)
    kernels.reset_launches()
    out = process_frames(frames, cfg, device=dev)
    sync(dev)
    launches = kernels.flow_launches()
    runs = flow_runs(n - 1, cfg.chunk, h, w, params)
    check(launches == runs and runs["gauss_solve"] > 0,
          f"accurate settings: expected launches {runs}, got {launches}")
    check(np.isfinite(out["mean_magnitude"]).all() and float(out["mean_magnitude"].max()) > 0.01,
          "accurate settings: non-finite or no motion")
    t = timed_s(dev, lambda: process_frames(frames, cfg, device=dev))
    print(f"slice accurate settings ({params.levels} levels, winsize {ws}, {params.iterations} iterations, "
          f"poly_n {params.poly_n}, Gaussian window): launches {launches}; "
          f"process_frames {(n - 1) / t:.2f} pairs/s {stamp}")
    return {**finest, "max_abs_err": err, "launches": launches}


def check_tables(got: dict, want: dict, tag: str) -> float:
    """The tables of two runs over the same pairs: the integer tables (hue,
    rgb_hue, centroids) bitwise equal and mean_magnitude within rtol 1e-6
    (a float reduction may choose its order by the batch shape). Returns the
    largest relative mean_magnitude difference."""
    for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        check(g.shape == w.shape and g.dtype == w.dtype, f"{tag} {k}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        if k != "mean_magnitude":
            check(np.array_equal(g, w), f"{tag} {k}: not bitwise equal ({int((g != w).sum())} entries differ)")
    g, w = np.asarray(got["mean_magnitude"]), np.asarray(want["mean_magnitude"])
    np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=f"{tag} mean_magnitude")
    return float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30)))


def timed_s(dev, fn) -> float:
    sync(dev)
    t = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t


def stream_phase(dev, stamp: str, frames: np.ndarray, want: dict, cfg) -> dict:
    """Phase 5b: process_video_stream's device loop over `frames` through the
    prefetch thread (io.video.prefetch_chunks, the thread the cv2 stream
    uses), checked against process_frames' tables of the same frames (`want`)
    and timed beside it in turns. Where cv2 is importable, also the whole
    stream (cv2 decode thread included) on demo_out/601_3.avi against
    process_frames of the same decoded frames. Returns the launches."""
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import (
        _stream_tables,
        process_frames,
        process_video_stream,
    )

    n, h, w = frames.shape[:3]

    def stream():
        with contextlib.closing(io_video.prefetch_chunks(iter(frames), cfg.chunk)) as chunks:
            return _stream_tables(chunks, cfg, dev)

    kernels.reset_launches()
    got = stream()
    sync(dev)
    launches = kernels.flow_launches()
    runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow)
    check(launches == runs, f"stream: expected launches {runs}, got {launches}")
    check("flow_bgr" not in got and got["hue_table"].shape == (n - 1, cfg.grid.rows * cfg.grid.cols),
          f"stream tables {sorted(got)} {got['hue_table'].shape}")
    rel = check_tables(got, want, "stream vs process_frames")
    print(f"stream {n}x{h}x{w} through the prefetch thread: launches {launches}; tables equal to "
          f"process_frames' (integer tables bitwise, mean_magnitude rel diff {rel:.3g})")

    if have_cv2():
        demo = "demo_out/601_3.avi"
        dec = io_video.read_video_bgr(demo, DEMO_FRAMES)
        kernels.reset_launches()
        got_demo = process_video_stream(demo, cfg, DEMO_FRAMES, device=dev)
        check(all(v for k, v in kernels.flow_launches().items() if k != "gauss_solve"),
              f"demo stream: a kernel was not launched: {kernels.flow_launches()}")
        check_tables(got_demo, process_frames(dec, cfg, dev), "demo stream (cv2) vs process_frames")
        print(f"stream {demo} ({dec.shape[0]} frames, cv2 decode thread): tables equal to process_frames'")

    feature_cfg = dataclasses.replace(cfg, emit_flow_bgr=False)
    runners = {"process_frames": lambda: process_frames(frames, feature_cfg, dev), "stream": stream}
    for fn in runners.values():  # warm-up
        fn()
    times = {k: [] for k in runners}
    for _ in range(REPEATS):
        for name, fn in runners.items():
            times[name].append(timed_s(dev, fn))
    for name, ts in times.items():
        print(f"time {name} {n}x{h}x{w} warp_mode={cfg.flow.warp_mode}, tables only: "
              f"{(n - 1) / float(np.median(ts)):.2f} pairs/s (median of {REPEATS}, in turns, runs "
              f"{', '.join(f'{t:.3f}' for t in ts)} s) {stamp}")
    return launches


@contextlib.contextmanager
def clip_files(tmp: str, clips: list[np.ndarray]):
    """Paths of `clips` for the queue's decoder. With cv2: MJPG files written
    under `tmp` and decoded by the real reader. Without it: paths that name
    no file, served from memory by a stand-in for io.video.read_video_bgr
    (the queue looks the decoder up there at call time)."""
    from opticalflowclustering_tpu_torch.io import video as io_video

    os.makedirs(os.path.join(tmp, "clips"), exist_ok=True)
    paths = [os.path.join(tmp, "clips", f"clip{i}.avi") for i in range(len(clips))]
    if have_cv2():
        for p, c in zip(paths, clips):
            io_video.write_video_mjpg(p, c, 30.0)
        yield paths
        return
    by_path = dict(zip(paths, clips))
    real = io_video.read_video_bgr

    def from_memory(path, max_frames=None):
        if path not in by_path:
            raise FileNotFoundError(f"cannot open video: {path}")
        return by_path[path][:max_frames]

    io_video.read_video_bgr = from_memory
    try:
        yield paths
    finally:
        io_video.read_video_bgr = real


def queue_phase(dev, stamp: str, clips: list[np.ndarray], cfg) -> dict:
    """Phase 5c: process_video_queue and process_video_queue_dp on a 2×2
    mesh of `dev` over `clips` (two batch, one is a leftover): artifacts
    equal, the mesh path ran (LAST_DP_STATS), kernel launches as the design
    implies; then videos/s of each queue, in turns. Returns the launches."""
    import tempfile

    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.pipeline import queue as vq

    mesh = make_mesh({"dp": 2, "sp": 2}, [dev] * 4)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    n, h, w = clips[0].shape[:3]
    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp, clip_files(tmp, clips) as paths:
        kernels.reset_launches()
        seq = vq.process_video_queue(paths, os.path.join(tmp, "seq"), cfg, device=dev)
        sync(dev)
        l_seq = kernels.flow_launches()
        kernels.reset_launches()
        dpr = vq.process_video_queue_dp(paths, os.path.join(tmp, "dp"), mesh, cfg)
        sync(dev)
        l_dp = kernels.flow_launches()
        stats = dict(vq.LAST_DP_STATS)
        check(all(r.ok and r.attempts == 1 for r in seq + dpr) and len(dpr) == len(paths),
              f"queue results: {[(r.video, r.ok, r.error) for r in seq + dpr]}")
        check(stats["batches"] >= 1 and stats["batch_failures"] == 0, f"LAST_DP_STATS {stats}")
        runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow, len(paths))
        singles = len(paths) - dp * stats["batches"]
        runs_dp = add_runs(flow_runs(1, 1, h, w, cfg.flow, dp * sp * stats["batches"]),
                           flow_runs(n - 1, cfg.chunk, h, w, cfg.flow, singles))
        check(l_seq == runs, f"queue: expected launches {runs}, got {l_seq}")
        check(l_dp == runs_dp, f"dp queue: expected launches {runs_dp}, got {l_dp}")
        worst = 0.0
        for r in seq:
            a = vq.load_features(r.path)
            b = vq.load_features(vq._artifact_path(os.path.join(tmp, "dp"), r.video))
            check(a["hue_table"].shape == (n - 1, cfg.grid.rows * cfg.grid.cols), f"artifact {a['hue_table'].shape}")
            worst = max(worst, check_tables(b, a, f"dp queue vs queue {os.path.basename(r.video)}"))
        print(f"queue {len(paths)} x {n}x{h}x{w}: launches {l_seq}; dp queue on a {dp}x{sp} mesh of {dev}: "
              f"launches {l_dp}, stats {stats}; artifacts equal (integer tables bitwise, mean_magnitude "
              f"rel diff {worst:.3g})")

        runners = {
            "process_video_queue": lambda: vq.process_video_queue(
                paths, os.path.join(tmp, "tseq"), cfg, resume=False, device=dev),
            "process_video_queue_dp": lambda: vq.process_video_queue_dp(
                paths, os.path.join(tmp, "tdp"), mesh, cfg, resume=False),
            "decode alone (io.video.read_video_bgr)": lambda: [io_video.read_video_bgr(p) for p in paths],
        }
        times = {k: [] for k in runners}
        for _ in range(REPEATS):
            for name, fn in runners.items():
                times[name].append(timed_s(dev, fn))
        for name, ts in times.items():
            print(f"time {name} {len(paths)} videos of {n}x{h}x{w}: "
                  f"{len(paths) / float(np.median(ts)):.3f} videos/s (median of {REPEATS}, in turns, runs "
                  f"{', '.join(f'{t:.3f}' for t in ts)} s; decode {'cv2' if have_cv2() else 'from memory'}) {stamp}")
    return {"queue": l_seq, "dp_queue": l_dp}


def temporal_phase(dev, videos: np.ndarray, cfg) -> dict:
    """Phase 5d: sharded_hue_pipeline_videos on a 2×2 mesh of `dev` against
    unsharded_hue_pipeline_videos on `dev`, with their launches."""
    import torch

    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.parallel.temporal import (
        sharded_hue_pipeline_videos,
        unsharded_hue_pipeline_videos,
    )

    mesh = make_mesh({"dp": 2, "sp": 2}, [dev] * 4)
    b, n, h, w = videos.shape[:4]
    kernels.reset_launches()
    got = sharded_hue_pipeline_videos(videos, mesh, grid=cfg.grid, params=cfg.flow, rb_swap=cfg.rb_swap)
    sync(dev)
    l_sh = kernels.flow_launches()
    kernels.reset_launches()
    want = unsharded_hue_pipeline_videos(videos, cfg.grid, cfg.flow, cfg.rb_swap, device=dev)
    sync(dev)
    l_un = kernels.flow_launches()
    check(l_sh == flow_runs(1, 1, h, w, cfg.flow, 4), f"temporal sharded launches {l_sh}")
    check(l_un == flow_runs(1, 1, h, w, cfg.flow), f"temporal unsharded launches {l_un}")
    keys = ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude")
    cells = cfg.grid.rows * cfg.grid.cols
    check(tuple(got[0].shape) == (b, n, cells) and tuple(got[2].shape) == (b, n, cells, 4),
          f"temporal shapes {[tuple(t.shape) for t in got]}")
    rel = check_tables({k: t.numpy() for k, t in zip(keys, got)},
                       {k: t.cpu().numpy() for k, t in zip(keys, want)}, "temporal sharded vs unsharded")
    check(bool(torch.isfinite(got[3]).all()) and float(got[3][:, : n - 1].max()) > 0.01, "temporal: no motion")
    print(f"temporal {list(videos.shape)} on a 2x2 mesh of {dev}: launches {l_sh} (unsharded {l_un}); "
          f"tables equal to the unsharded pipeline's (integer tables bitwise, mean_magnitude rel diff {rel:.3g})")
    return {"temporal": l_sh, "temporal_unsharded": l_un}


def findcosine_phase(series: np.ndarray, start: int, length: int) -> None:
    """Phase 5e: the findcosine CLI on the card (`--device cuda`) over CSVs
    of a hue series and of its window [start, start+length): the match must
    be that window, with similarity 1."""
    import io
    import tempfile

    from opticalflowclustering_tpu_torch.cli import findcosine

    series = np.asarray(series, np.float32)
    sig = series[start : start + length]
    check(float(np.abs(sig).sum()) > 0, "hue series window is all zero")
    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp:
        files = []
        for name, values in (("signature.csv", sig), ("series.csv", series)):
            files.append(os.path.join(tmp, name))
            with open(files[-1], "w") as f:
                f.writelines(f"{i},{float(v)!r}\n" for i, v in enumerate(values))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            findcosine.main(files + ["--device", "cuda"])
    lines = out.getvalue().splitlines()
    check(len(lines) == 4 and lines[0].split() == ["Vector", "sizes", "are:", str(length), str(len(series))],
          f"findcosine printed {lines}")
    sim, frame = float(lines[1].split(":")[1]), int(lines[3].split(":")[1])
    check(sim >= 1 - 1e-6 and np.array_equal(series[frame : frame + length], sig),
          f"findcosine: similarity {sim} at frame {frame}, window planted at {start}")
    print(f"findcosine --device cuda: {' | '.join(lines)} (window planted at {start})")


@contextlib.contextmanager
def counted_decoders(pairs: dict):
    """Count the pairs that reach process_video_stream through each decoder
    (pairs[name] += n_valid per batch): the native one
    (io.fastio.stream_mjpeg_avi) and cv2's (io.video.stream_video_chunks)."""
    from opticalflowclustering_tpu_torch.io import fastio
    from opticalflowclustering_tpu_torch.io import video as io_video

    sources = {"native": (fastio, "stream_mjpeg_avi"), "cv2": (io_video, "stream_video_chunks")}
    real = {name: getattr(module, attr) for name, (module, attr) in sources.items()}

    def counting(name):
        def gen(*args, **kwargs):
            with contextlib.closing(real[name](*args, **kwargs)) as batches:
                for batch, n_valid in batches:
                    pairs[name] += n_valid
                    yield batch, n_valid
        return gen

    try:
        for name, (module, attr) in sources.items():
            pairs[name] = 0
            setattr(module, attr, counting(name))
        yield pairs
    finally:
        for name, (module, attr) in sources.items():
            setattr(module, attr, real[name])


def write_mjpeg_avi(path: str, jpegs: list[bytes], h: int, w: int, fps: int = 30) -> None:
    """An MJPEG AVI of the given JPEG frames: RIFF 'AVI ' with the hdrl
    header (avih, one 'vids' 'MJPG' stream), a movi LIST of '00dc' chunks
    and an idx1 index, enough for the native decoder and for cv2's."""
    import struct

    def chunk(tag, data):
        return tag + struct.pack("<I", len(data)) + data + b"\0" * (len(data) & 1)

    def group(kind, body):
        return b"LIST" + struct.pack("<I", 4 + len(body)) + kind + body

    n, largest = len(jpegs), max(len(j) for j in jpegs)
    avih = struct.pack("<14I", 1_000_000 // fps, 0, 0, 0x10, n, 0, 1, largest, w, h, 0, 0, 0, 0)
    strh = b"vidsMJPG" + struct.pack("<IHHIIIIIIIIhhhh", 0, 0, 0, 0, 1, fps, 0, n, largest, 0xFFFFFFFF, 0,
                                     0, 0, w, h)
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
    hdrl = group(b"hdrl", chunk(b"avih", avih) + group(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi, index, offset = [], [], 4
    for j in jpegs:
        movi.append(chunk(b"00dc", j))
        index.append(b"00dc" + struct.pack("<III", 0x10, offset, len(j)))  # AVIIF_KEYFRAME
        offset += len(movi[-1])
    body = hdrl + group(b"movi", b"".join(movi)) + chunk(b"idx1", b"".join(index))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"AVI " + body)


def sof_at(jpeg: bytes) -> int:
    """The offset of a JPEG's SOF marker."""
    i = 2
    while not (0xC0 <= jpeg[i + 1] <= 0xCF and jpeg[i + 1] not in (0xC4, 0xC8, 0xCC)):
        i += 2 + int.from_bytes(jpeg[i + 2 : i + 4], "big")
    return i


def jpeg_sof(jpeg: bytes) -> int:
    """The SOF marker of a JPEG (0xC0 baseline, 0xC2 progressive, ...)."""
    return jpeg[sof_at(jpeg) + 1]


def jpeg_size(jpeg: bytes) -> tuple[int, int]:
    """(height, width) from a JPEG's SOF."""
    i = sof_at(jpeg)
    return int.from_bytes(jpeg[i + 5 : i + 7], "big"), int.from_bytes(jpeg[i + 7 : i + 9], "big")


def native_progressive_checks(dev, stamp: str, frames: np.ndarray, cfg, tmp: str, host: str) -> dict:
    """Phase 5m, progressive frames (SOF2): `frames` re-encoded by cv2 at
    REENCODE_QUALITY, 4:2:0, baseline and progressive, each clip muxed by
    write_mjpeg_avi. The progressive clip decodes natively to the baseline
    clip's bytes at 1 thread and at every core, within 5 codes (mean < 1) of
    cv2's decode of it; process_video_stream(native=True) on it, with the
    launches and the pairs through each decoder counted, gives the baseline
    clip's native stream's tables bitwise. Then decode frames/s (native
    progressive at every core and 1 thread, native baseline at both, cv2 of
    the progressive clip) and the native stream's pairs/s on both clips, in
    turns. Returns the progressive stream's launches."""
    import cv2

    from opticalflowclustering_tpu_torch.io import fastio
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import process_video_stream

    cores = os.cpu_count() or 1
    n, h, w = frames.shape[:3]
    params = [cv2.IMWRITE_JPEG_QUALITY, REENCODE_QUALITY,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420]
    paths, sizes = {}, {}
    for kind, progressive in (("baseline", 0), ("progressive", 1)):
        jpegs = []
        for f in frames:
            ok, buf = cv2.imencode(".jpg", f, params + [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive])
            check(ok, f"cv2 did not encode a {kind} frame")
            jpegs.append(buf.tobytes())
        sofs = {jpeg_sof(j) for j in jpegs}
        check(sofs == {0xC2 if progressive else 0xC0}, f"{kind} clip: SOF markers {sorted(map(hex, sofs))}")
        paths[kind] = os.path.join(tmp, f"{kind}.avi")
        write_mjpeg_avi(paths[kind], jpegs, h, w)
        sizes[kind] = sum(map(len, jpegs))
    decoded = {}
    for kind, path in paths.items():
        one = fastio.decode_mjpeg_avi(path, threads=1)
        check(one.shape == frames.shape, f"{kind} clip: native decode {one.shape}")
        check(np.array_equal(one, fastio.decode_mjpeg_avi(path, threads=cores)),
              f"{kind} clip: 1 thread and {cores} threads decode differently")
        decoded[kind] = one
    check(np.array_equal(decoded["progressive"], decoded["baseline"]),
          "the progressive clip decodes natively to other bytes than the baseline clip")
    ref = io_video.read_video_bgr(paths["progressive"])
    check(ref.shape == frames.shape, f"progressive clip: cv2 decode {ref.shape}")
    gap = np.abs(decoded["progressive"].astype(np.int16) - ref.astype(np.int16))
    check(int(gap.max()) <= 5 and float(gap.mean()) < 1.0,
          f"progressive clip: native vs cv2 largest gap {int(gap.max())}, mean {float(gap.mean())}")
    check(np.array_equal(io_video.read_video_bgr(paths["progressive"], native=True), decoded["progressive"]),
          "progressive clip: read_video_bgr(native=True)")
    print(f"native decode of {n} {w}x{h} frames re-encoded by cv2 {cv2.__version__} at quality "
          f"{REENCODE_QUALITY} 4:2:0, baseline ({sizes['baseline']} bytes of JPEG) and progressive SOF2 "
          f"({sizes['progressive']} bytes): progressive = baseline bitwise at 1 and {cores} threads; progressive "
          f"vs cv2 largest gap {int(gap.max())} codes, mean {float(gap.mean()):.4f} (contract <= 5, < 1)")

    want = process_video_stream(paths["baseline"], cfg, None, True, device=dev)
    kernels.reset_launches()
    with counted_decoders({}) as pairs:
        got = process_video_stream(paths["progressive"], cfg, None, True, device=dev)
    sync(dev)
    launches = kernels.flow_launches()
    runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow)
    check(launches == runs, f"progressive native stream: expected launches {runs}, got {launches}")
    check(pairs == {"native": n - 1, "cv2": 0},
          f"progressive native stream: pairs by decoder {pairs}, expected {n - 1} native")
    for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
        check(np.array_equal(np.asarray(got[k]), np.asarray(want[k])),
              f"progressive native stream {k}: not bitwise the baseline clip's")
    print(f"native stream of the progressive clip {n}x{h}x{w} warp_mode={cfg.flow.warp_mode}: launches {launches} "
          f"(design {runs}); {pairs['native'] + 1} frames through the native decoder, {pairs['cv2']} through "
          f"cv2; tables bitwise equal to the baseline clip's native stream")

    decoders = {f"progressive native {cores} threads": lambda: fastio.decode_mjpeg_avi(paths["progressive"],
                                                                                       threads=cores),
                "progressive native 1 thread": lambda: fastio.decode_mjpeg_avi(paths["progressive"], threads=1),
                f"baseline native {cores} threads": lambda: fastio.decode_mjpeg_avi(paths["baseline"],
                                                                                    threads=cores),
                "baseline native 1 thread": lambda: fastio.decode_mjpeg_avi(paths["baseline"], threads=1),
                "progressive cv2": lambda: io_video.read_video_bgr(paths["progressive"])}
    times = {k: [] for k in decoders}
    for _ in range(REPEATS):
        for k, fn in decoders.items():
            times[k].append(timed_s(dev, fn))
    rates = ", ".join(f"{k} {n / float(np.median(v)):.1f}" for k, v in times.items())
    print(f"time decode re-encoded {w}x{h} clip ({n} frames, quality {REENCODE_QUALITY} 4:2:0), frames/s: "
          f"{rates} (median of {REPEATS}, in turns; {host}) {stamp}")
    streams = {kind: lambda path=path: process_video_stream(path, cfg, None, True, device=dev)
               for kind, path in paths.items()}
    times = {k: [] for k in streams}
    for _ in range(REPEATS):
        for k, fn in streams.items():
            times[k].append(timed_s(dev, fn))
    for k, ts in times.items():
        print(f"time stream {n}x{h}x{w} native decode of the {k} clip (decode included): "
              f"{(n - 1) / float(np.median(ts)):.2f} pairs/s (median of {REPEATS}, in turns, runs "
              f"{', '.join(f'{t:.3f}' for t in ts)} s; {host}) {stamp}")
    return launches


def native_arith_checks(dev, stamp: str, n: int, cfg, tmp: str, host: str) -> dict:
    """Phase 5m, arithmetic-coded frames (SOF9, SOF10), which no encoder on
    this machine writes: the committed re-codings of demo_out/601_3.avi
    decode natively to its bytes (DEMO_NATIVE_SHA256); n-frame clips that
    cycle the ARITH_TILES, muxed by write_mjpeg_avi from the baseline JPEGs
    and from their SOF9 and SOF10 re-codings, decode natively to the
    baseline clip's bytes, each at 1 thread and at every core; and
    process_video_stream(native=True) on each arithmetic clip, with the
    launches and the pairs through each decoder counted, gives the baseline
    clip's native stream's tables bitwise. Then decode frames/s (native
    SOF9, SOF10 and baseline at every core and at 1 thread) and the native
    stream's pairs/s on the three clips, in turns. Returns the SOF9 and
    SOF10 streams' launches."""
    import hashlib

    from opticalflowclustering_tpu_torch.io import fastio
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import process_video_stream

    cores = os.cpu_count() or 1
    kinds = {"sof9": (".sof9.jpg", 0xC9), "sof10": (".sof10.jpg", 0xCA), "baseline": (".jpg", 0xC0)}
    demo = fastio.decode_mjpeg_avi("demo_out/601_3.avi", threads=cores)
    for kind in ("sof9", "sof10"):
        path = os.path.join(ARITH_GOLDEN, f"demo_{kind}.avi")
        for threads in (1, cores):
            got = fastio.decode_mjpeg_avi(path, threads=threads)
            check(np.array_equal(got, demo), f"{path}: the native decode at {threads} threads is not the demo clip's")
        check(hashlib.sha256(got.tobytes()).hexdigest() == DEMO_NATIVE_SHA256, f"{path}: not JAX's libjpeg decode")
    print(f"native decode of demo_out/601_3.avi's {demo.shape[0]} frames re-coded SOF9 and SOF10 "
          f"({ARITH_GOLDEN}/demo_sof9.avi, demo_sof10.avi): bitwise the demo clip's at 1 and {cores} threads "
          f"(sha256 {DEMO_NATIVE_SHA256})")

    paths, sizes = {}, {}
    for kind, (suffix, sof) in kinds.items():
        tiles = []
        for tile in ARITH_TILES:
            with open(os.path.join(ARITH_GOLDEN, tile + suffix), "rb") as f:
                tiles.append(f.read())
            check(jpeg_sof(tiles[-1]) == sof, f"{tile}{suffix}: SOF {jpeg_sof(tiles[-1]):#x}, expected {sof:#x}")
        jpegs = [tiles[i % len(tiles)] for i in range(n)]
        paths[kind] = os.path.join(tmp, f"arith_{kind}.avi")
        write_mjpeg_avi(paths[kind], jpegs, *jpeg_size(tiles[0]))
        sizes[kind] = sum(map(len, tiles))
    decoded = {}
    for kind, path in paths.items():
        one = fastio.decode_mjpeg_avi(path, threads=1)
        check(one.shape[0] == n, f"{kind} clip: native decode {one.shape}")
        check(np.array_equal(one, fastio.decode_mjpeg_avi(path, threads=cores)),
              f"{kind} clip: 1 thread and {cores} threads decode differently")
        decoded[kind] = one
    _, h, w, _ = decoded["baseline"].shape
    for kind in ("sof9", "sof10"):
        check(np.array_equal(decoded[kind], decoded["baseline"]),
              f"the {kind} clip decodes natively to other bytes than the baseline clip")
        check(np.array_equal(io_video.read_video_bgr(paths[kind], native=True), decoded[kind]),
              f"{kind} clip: read_video_bgr(native=True)")
    print(f"native decode of {n} {w}x{h} frames cycling {', '.join(ARITH_TILES)}: baseline "
          f"({sizes['baseline']} bytes of JPEG per cycle), SOF9 ({sizes['sof9']}) and SOF10 ({sizes['sof10']}): "
          f"SOF9 = SOF10 = baseline bitwise at 1 and {cores} threads")

    want = process_video_stream(paths["baseline"], cfg, None, True, device=dev)
    runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow)
    launches = {}
    for kind in ("sof9", "sof10"):
        kernels.reset_launches()
        with counted_decoders({}) as pairs:
            got = process_video_stream(paths[kind], cfg, None, True, device=dev)
        sync(dev)
        launches[kind] = kernels.flow_launches()
        check(launches[kind] == runs, f"{kind} native stream: expected launches {runs}, got {launches[kind]}")
        check(pairs == {"native": n - 1, "cv2": 0}, f"{kind} native stream: pairs by decoder {pairs}, "
              f"expected {n - 1} native")
        for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
            check(np.array_equal(np.asarray(got[k]), np.asarray(want[k])),
                  f"{kind} native stream {k}: not bitwise the baseline clip's")
        print(f"native stream of the {kind} clip {n}x{h}x{w} warp_mode={cfg.flow.warp_mode}: launches "
              f"{launches[kind]} (design {runs}); {pairs['native'] + 1} frames through the native decoder, "
              f"{pairs['cv2']} through cv2; tables bitwise equal to the baseline clip's native stream")

    decoders = {f"{kind} native {t}": (lambda path=path, threads=threads:
                                       fastio.decode_mjpeg_avi(path, threads=threads))
                for kind, path in paths.items()
                for t, threads in ((f"{cores} threads", cores), ("1 thread", 1))}
    times = {k: [] for k in decoders}
    for _ in range(REPEATS):
        for k, fn in decoders.items():
            times[k].append(timed_s(dev, fn))
    rates = ", ".join(f"{k} {n / float(np.median(v)):.1f}" for k, v in times.items())
    print(f"time decode arithmetic {w}x{h} clip ({n} frames), frames/s: {rates} (median of {REPEATS}, "
          f"in turns; {host}) {stamp}")
    streams = {kind: lambda path=path: process_video_stream(path, cfg, None, True, device=dev)
               for kind, path in paths.items()}
    times = {k: [] for k in streams}
    for _ in range(REPEATS):
        for k, fn in streams.items():
            times[k].append(timed_s(dev, fn))
    for k, ts in times.items():
        print(f"time stream {n}x{h}x{w} native decode of the {k} clip (decode included): "
              f"{(n - 1) / float(np.median(ts)):.2f} pairs/s (median of {REPEATS}, in turns, runs "
              f"{', '.join(f'{t:.3f}' for t in ts)} s; {host}) {stamp}")
    return {"native_stream_sof9": launches["sof9"], "native_stream_sof10": launches["sof10"]}


def native_decode_phase(dev, stamp: str, frames: np.ndarray, cfg) -> dict:
    """Phase 5m: the native MJPEG decoder (io.fastio over the port's
    native/fastio.cpp, built from the checkout with g++ alone) and its
    stream. `frames` are written as an MJPG AVI and decoded with it beside
    demo_out/601_3.avi, at 1 thread and at every core: the two give the same
    bytes, the demo clip's frames hash to DEMO_NATIVE_SHA256 (the JAX
    package's libjpeg decode, pinned by tests/test_torch_fastio.py), and both
    clips are within 5 codes (mean < 1) of cv2's decode. Then
    process_video_stream(native=True) in `cfg`'s mode, with its kernel
    launches and the pairs through each decoder counted: its tables equal
    process_frames' of the natively decoded frames on the card. Then decode
    frames/s (native at every core and at 1 thread, cv2) on both clips, and
    stream pairs/s native and cv2, in turns. Then the progressive frames'
    checks and times (native_progressive_checks), and the arithmetic-coded
    ones' (native_arith_checks, on n-frame clips). Returns the launches of
    the native stream and of the progressive, SOF9 and SOF10 clips' native
    streams, by path."""
    import hashlib
    import tempfile

    from opticalflowclustering_tpu_torch.io import fastio
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import process_frames, process_video_stream

    check(have_cv2(), "the native decoder's clip and its cv2 comparison need cv2, which is not importable")
    cores = os.cpu_count() or 1
    host = f"host {cores} cores ({len(os.sched_getaffinity(0))} usable)"
    t0 = time.perf_counter()
    check(fastio.available(), "the native decoder did not load")
    print(f"native decoder: built with `{' '.join(fastio.build_command('<so>'))}` into {fastio.BUILD_DIR} "
          f"in {time.perf_counter() - t0:.1f} s (no codec library); {host}")
    n, h, w = frames.shape[:3]
    with tempfile.TemporaryDirectory(prefix="ofc-native-") as tmp:
        path = os.path.join(tmp, "clip.avi")
        io_video.write_video_mjpg(path, frames, 30.0)
        clips = {f"{w}x{h} clip": path, "demo_out/601_3.avi": "demo_out/601_3.avi"}
        decoded = {}
        for name, clip in clips.items():
            one = fastio.decode_mjpeg_avi(clip, threads=1)
            pooled = fastio.decode_mjpeg_avi(clip, threads=cores)
            check(np.array_equal(one, pooled), f"{name}: 1 thread and {cores} threads decode differently")
            ref = io_video.read_video_bgr(clip)
            check(one.shape == ref.shape, f"{name}: native {one.shape} vs cv2 {ref.shape}")
            gap = np.abs(one.astype(np.int16) - ref.astype(np.int16))
            check(int(gap.max()) <= 5 and float(gap.mean()) < 1.0,
                  f"{name}: native vs cv2 largest gap {int(gap.max())}, mean {float(gap.mean())}")
            check(np.array_equal(io_video.read_video_bgr(clip, native=True), one), f"{name}: read_video_bgr(native=True)")
            digest = hashlib.sha256(one.tobytes()).hexdigest()
            print(f"native decode {name} {one.shape}: 1 and {cores} threads bitwise equal; vs cv2 largest gap "
                  f"{int(gap.max())} codes, mean {float(gap.mean()):.4f} (contract <= 5, < 1); sha256 {digest}")
            decoded[name] = one
        demo = hashlib.sha256(decoded["demo_out/601_3.avi"].tobytes()).hexdigest()
        check(demo == DEMO_NATIVE_SHA256, f"demo clip decodes to {demo}, not JAX's libjpeg decode {DEMO_NATIVE_SHA256}")
        check(np.array_equal(decoded[f"{w}x{h} clip"], fastio.decode_mjpeg_avi(path)), "720p clip: default threads")

        kernels.reset_launches()
        with counted_decoders({}) as pairs:
            got = process_video_stream(path, cfg, None, True, device=dev)
        sync(dev)
        launches = kernels.flow_launches()
        runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow)
        check(launches == runs, f"native stream: expected launches {runs}, got {launches}")
        check(pairs == {"native": n - 1, "cv2": 0}, f"native stream: pairs by decoder {pairs}, expected {n - 1} native")
        rel = check_tables(got, process_frames(decoded[f"{w}x{h} clip"], dataclasses.replace(cfg, emit_flow_bgr=False), dev),
                           "native stream vs process_frames of the native decode")
        print(f"native stream {n}x{h}x{w} warp_mode={cfg.flow.warp_mode}: launches {launches} (design {runs}); "
              f"{pairs['native'] + 1} frames through the native decoder, {pairs['cv2']} through cv2; tables equal to "
              f"process_frames' of the natively decoded frames (integer tables bitwise, mean_magnitude rel diff {rel:.3g})")

        for name, clip in clips.items():
            count = decoded[name].shape[0]
            decoders = {f"native {cores} threads": lambda clip=clip: fastio.decode_mjpeg_avi(clip, threads=cores),
                        "native 1 thread": lambda clip=clip: fastio.decode_mjpeg_avi(clip, threads=1),
                        "cv2": lambda clip=clip: io_video.read_video_bgr(clip)}
            times = {k: [] for k in decoders}
            for _ in range(REPEATS):
                for k, fn in decoders.items():
                    times[k].append(timed_s(dev, fn))
            rates = ", ".join(f"{k} {count / float(np.median(v)):.1f}" for k, v in times.items())
            print(f"time decode {name} ({count} frames {decoded[name].shape[2]}x{decoded[name].shape[1]}), frames/s: "
                  f"{rates} (median of {REPEATS}, in turns; {host}) {stamp}")
        streams = {"native": lambda: process_video_stream(path, cfg, None, True, device=dev),
                   "cv2": lambda: process_video_stream(path, cfg, None, False, device=dev)}
        times = {k: [] for k in streams}
        for _ in range(REPEATS):
            for k, fn in streams.items():
                times[k].append(timed_s(dev, fn))
        for k, ts in times.items():
            print(f"time stream {n}x{h}x{w} {k} decode (decode included): {(n - 1) / float(np.median(ts)):.2f} pairs/s "
                  f"(median of {REPEATS}, in turns, runs {', '.join(f'{t:.3f}' for t in ts)} s; {host}) {stamp}")
        progressive = native_progressive_checks(dev, stamp, frames, cfg, tmp, host)
        arith = native_arith_checks(dev, stamp, n, cfg, tmp, host)
    return {"native_stream": launches, "native_stream_progressive": progressive, **arith}


def epe_phase(dev, stamp: str, frames: np.ndarray) -> int:
    """Phase 5n: mean EPE of farneback_flow on the card against
    cv2.calcOpticalFlowFarneback(prev, next, None, 0.5, 3, 15, 3, 5, 1.2, 0)
    in each warp mode, on 4 pairs of `frames` and 4 pairs of real footage
    (demo_out/601_3.avi frames 30–34): below 1e-3 px for exact and fast,
    0.01 px for fast16 (the JAX package's gates, tests/test_pallas_warp.py).
    Returns the launches of each pipeline kernel that the design makes: one
    batched flow per clip in each kernel mode (fast, fast16)."""
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray

    gates = {"exact": 1e-3, "fast": 1e-3, "fast16": 1e-2}
    design = []
    clips = {f"synthetic {frames.shape[2]}x{frames.shape[1]}": frames[:5],
             "demo_out/601_3.avi 220x232": io_video.read_video_bgr("demo_out/601_3.avi", 35)[30:35]}
    for name, clip in clips.items():
        gray = bgr2gray(torch.from_numpy(clip))
        want = np.stack([cv2.calcOpticalFlowFarneback(gray[i].numpy(), gray[i + 1].numpy(), None,
                                                      0.5, 3, 15, 3, 5, 1.2, 0) for i in range(4)])
        g = gray.to(dev)
        parts = []
        for mode, gate in gates.items():
            got = farneback_flow(g[:-1], g[1:], FarnebackParams(warp_mode=mode)).cpu().numpy()
            epe = np.sqrt(((got - want) ** 2).sum(-1)).mean(axis=(1, 2))
            check(bool(np.isfinite(epe).all()) and float(epe.max()) < gate,
                  f"EPE vs cv2 {name} {mode}: {epe.tolist()} (gate {gate})")
            parts.append(f"{mode} {float(epe.mean()):.3g} (worst pair {float(epe.max()):.3g}, gate {gate:g})")
        print(f"EPE vs cv2 {cv2.__version__} calcOpticalFlowFarneback, 4 pairs of {name} (max |flow| "
              f"{float(np.abs(want).max()):.1f} px), mean px: {'; '.join(parts)} {stamp}")
        design += [flow_runs(4, 4, clip.shape[1], clip.shape[2], FarnebackParams(warp_mode=m)) for m in gates]
    return add_runs(*design)


def drawgrids_phase(dev, stamp: str, clip: str, tmp: str) -> tuple[str, dict]:
    """Phase 5o: the drawgrids CLI (--dump-cells, --device cuda) on the MJPG
    clip, timed, and the same CLI on the CPU at --max-frames
    DRAWGRIDS_CPU_FRAMES (a copy of the clip in a directory of its own): the
    CPU's `_rgb_values.csv` rows equal the card's first rows byte for byte.
    Returns the card's OutImgs tree and the card run's launches."""
    import shutil

    from opticalflowclustering_tpu_torch.cli import drawgrids

    name = os.path.basename(clip).split(".")[0]
    runs = {}
    for where, extra in (("cuda", []), ("cpu", ["--max-frames", str(DRAWGRIDS_CPU_FRAMES)])):
        d = os.path.join(tmp, f"drawgrids_{where}")
        os.makedirs(d)
        path = shutil.copy(clip, d)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.chdir(d):
            lines, _ = run_cli(drawgrids.main, ["--path", path, "--noyolo", "--nocontour", "--dump-cells",
                                                "--device", where] + extra)
        sync(dev)
        if where == "cuda":
            launches = kernels.flow_launches()
        with open(path + "_rgb_values.csv") as f:
            runs[where] = (time.perf_counter() - t0, f.read().splitlines(), lines)
    (t, card, lines), (_, cpu, _) = runs["cuda"], runs["cpu"]
    tree = os.path.join(tmp, "drawgrids_cuda", "OutImgs", name)
    n_cells = sum(len(files) for _, _, files in os.walk(tree))
    check(len(cpu) == DRAWGRIDS_CPU_FRAMES and card[: len(cpu)] == cpu,
          f"drawgrids rgb_values: CPU rows {cpu[1:2]} vs card {card[1:2]}")
    print(f"drawgrids --dump-cells --device cuda on {clip}: {' | '.join(lines)}; {n_cells} cell PNGs; "
          f"rgb_values rows equal to the CPU run's at --max-frames {DRAWGRIDS_CPU_FRAMES} ({len(cpu) - 1} rows); "
          f"{t:.2f} s with "
          f"decode, writes and the MJPG output {stamp}")
    return tree, launches


def celltree_phase(dev, stamp: str, clip: str, tree: str, tmp: str) -> dict:
    """Phase 5p: the kmeangrids CLI with a Git-LFS pointer stub as --path
    over drawgrids' cell tree of `clip` (--device cuda), timed as cells/s:
    its hue table equals grid_cluster_stage's on the same rendered frames
    (the own-rectangle lines are in the PNGs) bitwise, and it writes one -f
    row per cell. Returns the CLI run's launches."""
    from opticalflowclustering_tpu_torch.cli import kmeangrids
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, grid_cluster_stage, process_frames

    d = os.path.join(tmp, "celltree")
    os.makedirs(d)
    stub = os.path.join(d, "clip.mp4")
    with open(stub, "w") as f:
        f.write("version https://git-lfs.github.com/spec/v1\noid sha256:0\nsize 0\n")
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(d):
        lines, _ = run_cli(kmeangrids.main, ["-d", tree, "-c", "1", "-f", "addnew.csv", "--noyolo", "--nocontour",
                                             "--path", stub, "--device", "cuda"])
    sync(dev)
    t = time.perf_counter() - t0
    launches = kernels.flow_launches()
    name = os.path.basename(tree)
    got = np.loadtxt(os.path.join(d, "OutCSV", f"{name}.csv"), delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    flow_bgr = process_frames(io_video.read_video_bgr(clip), PipelineConfig(), dev)["flow_bgr"]
    want = grid_cluster_stage(flow_bgr, GridParams(), True, dev)[1].cpu().numpy()
    with open(os.path.join(d, "addnew.csv")) as f:
        rows = sum(1 for _ in f)
    check(lines[0].endswith("instead") and got.shape == want.shape and np.array_equal(got, want),
          f"celltree: {lines}, table {got.shape} vs grid_cluster_stage {want.shape}")
    check(rows == want.size, f"celltree: {rows} -f rows for {want.size} cells")
    print(f"kmeangrids cell-tree path (LFS stub --path) --device cuda: {lines[-1]}; hue table bitwise equal to "
          f"grid_cluster_stage's on the rendered frames; {want.size / t:.0f} cells/s ({t:.2f} s with PNG decode and "
          f"CSV writes) {stamp}")
    return launches


def vectordistance_phase(series: np.ndarray, rgb_series: np.ndarray, tmp: str) -> None:
    """Phase 5q: the vectordistance CLI (--device cuda) on two hue CSVs of
    the run, of different lengths: the first two thirds of the clip's
    dominant-hue series and its whole mean-BGR-hue series. The same lines as
    the CPU run, the cosine and the Euclidean distance within 1e-6
    relative."""
    from opticalflowclustering_tpu_torch.cli import vectordistance

    files = []
    for name, values in (("hue.csv", series[: len(series) * 2 // 3]), ("rgb_hue.csv", rgb_series)):
        files.append(os.path.join(tmp, name))
        with open(files[-1], "w") as f:
            f.writelines(f"{i + 2}.png,{float(v)!r}\n" for i, v in enumerate(values))
    out = {where: run_cli(vectordistance.main, files + ["--device", where])[0] for where in ("cuda", "cpu")}
    card, cpu = out["cuda"], out["cpu"]
    check(len(card) == len(cpu) == 3 and card[0] == cpu[0] and "different lengths" in card[0],
          f"vectordistance printed {card}, the CPU {cpu}")
    for a, b in zip(card[1:], cpu[1:]):
        va, vb = float(a.split(": ")[1]), float(b.split(": ")[1])
        check(a.split(": ")[0] == b.split(": ")[0] and abs(va - vb) <= 1e-6 * abs(vb), f"vectordistance {a} vs {b}")
    print(f"vectordistance --device cuda on {len(series) * 2 // 3} and {len(rgb_series)} hues: "
          f"{' | '.join(card[1:])}; CPU: {' | '.join(cpu[1:])} (within 1e-6)")


def surface_phases(dev, stamp: str, frames: np.ndarray, series: np.ndarray, rgb_series: np.ndarray) -> dict:
    """Phases 5n-5q at the clip's size, each run with the kernel launch
    counts set to 0 just before it and read just after and held against its
    design: EPE against cv2 (the poly kernel in every mode, warp_m and
    box_solve in fast and fast16), drawgrids (its card run: the poly kernel
    of the exact flow), the kmeangrids cell-tree path (its CLI run) and
    vectordistance (no kernel). Returns the launches by path."""
    import tempfile

    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig

    check(have_cv2(), "EPE against cv2 and the grid CLIs' MJPG clip need cv2, which is not importable")
    launches = {}

    def counted(name, fn):
        kernels.reset_launches()
        result = fn()
        sync(dev)
        launches[name] = kernels.flow_launches()
        return result

    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp:
        clip = os.path.join(tmp, "clip.avi")
        io_video.write_video_mjpg(clip, frames, 30.0)
        epe = counted("epe", lambda: epe_phase(dev, stamp, frames))
        check(launches["epe"] == epe, f"epe: expected launches {epe}, got {launches['epe']}")
        tree, launches["drawgrids"] = drawgrids_phase(dev, stamp, clip, tmp)
        cfg = PipelineConfig()  # the CLI's: the exact flow over the whole clip
        runs = flow_runs(frames.shape[0] - 1, cfg.chunk, *frames.shape[1:3], cfg.flow)
        check(launches["drawgrids"] == runs, f"drawgrids: expected launches {runs}, got {launches['drawgrids']}")
        launches["celltree"] = celltree_phase(dev, stamp, clip, tree, tmp)
        counted("vectordistance", lambda: vectordistance_phase(series, rgb_series, tmp))
    for name in ("celltree", "vectordistance"):
        check(not any(launches[name].values()), f"{name} launched {launches[name]}")
    return launches


def circles_image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """[h, w] uint8: 8 filled discs (radius 60-110 px at 720p, scaled with
    h) on a flat ground, Gaussian-blurred 9×9 as a camera softens them; at
    1280x720 cv2.HoughCircles finds 7 of them at the demo's defaults."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.full((h, w), 40, np.uint8)
    s = h / 720
    for i in range(8):
        r = int(rng.integers(60, 110) * s)
        cv2.circle(img, (int((160 + 320 * (i % 4)) * s), int((180 + 360 * (i // 4)) * s)), r,
                   int(rng.integers(150, 250)), -1)
    return cv2.GaussianBlur(img, (9, 9), 0)


def overlay_inputs(root: str, video: str, n_frames: int, h: int, w: int, seed: int = 0) -> tuple[int, int]:
    """Writes `root`/yolo_labels.txt with 1-2 boxes (some cut by the frame
    edge) on every third frame from 3, and `root`/Contours/<video>/<video>_<n>.txt
    with 1-2 star polygons of 50-300 vertices on every third frame from 4.
    Returns (boxes, polygons)."""
    rng = np.random.default_rng(seed)
    rows, n_polys = [], 0
    cdir = os.path.join(root, "Contours", video)
    os.makedirs(cdir)
    for f in range(2, n_frames + 1):
        if f % 3 == 0:
            for _ in range(rng.integers(1, 3)):
                rows.append([f, 0, 0, rng.integers(-20, w), rng.integers(-20, h), rng.integers(20, w // 3),
                             rng.integers(20, h // 3), 0, 0, 0, 0])
        elif f % 3 == 1:
            lines = []
            for k in range(rng.integers(1, 3)):
                n = int(rng.integers(50, 301))
                a = np.sort(rng.uniform(0, 2 * np.pi, n))
                r = rng.uniform(0.02, 0.2, n) * min(h, w)
                cx, cy = rng.integers(0, w), rng.integers(0, h)
                pts = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], -1).round().astype(np.int64)
                lines.append(" ".join(map(str, [k, *pts.ravel()])))
            n_polys += len(lines)
            with open(os.path.join(cdir, f"{video}_{f}.txt"), "w") as fh:
                fh.write("\n".join(lines) + "\n")
    np.savetxt(os.path.join(root, "yolo_labels.txt"), np.array(rows, np.float64))
    return len(rows), n_polys


def draw_overlays_on_host(flow_bgr: np.ndarray, root: str, video: str) -> np.ndarray:
    """A copy of rendered frames [n, H, W, 3] (pair i is frame i + 2) with the
    overlays of `root` drawn by io.overlays on numpy arrays."""
    from opticalflowclustering_tpu_torch.io import overlays as ov

    out = flow_bgr.copy()
    boxes = ov.load_yolo_boxes(os.path.join(root, "yolo_labels.txt"))
    for i in range(out.shape[0]):
        for x, y, w, h in ov.yolo_rects_for_frame(boxes, i + 2):
            ov.draw_rect_outline(out[i], x, y, w, h)
        ov.apply_contour_mask(out[i], ov.load_contour_polys(os.path.join(root, "Contours"), video, i + 2))
    return out


def overlay_phase(dev, stamp: str, frames: np.ndarray, tmp: str) -> dict:
    """Phase 5r: the kmeangrids CLI called as its users call it, with its
    default flags (overlays on, `fast`, --device cuda), over `frames` written
    as an MJPG AVI and the yolo_labels.txt and Contours/ of
    `overlay_inputs`, with its kernel launches counted and held against the
    design. Its hue table equals grid_cluster_stage's over process_frames'
    `fast` render with the overlays drawn on the host (io.overlays on
    numpy) bitwise; pairs/s of the overlay path (process_frames with an
    OverlaySpec) beside feature-only process_frames, in turns; the overlay
    path's rendered frames (all of them, the clip's first 3 frames
    included) equal the host drawing byte for byte. Returns the CLI's
    launches."""
    from opticalflowclustering_tpu_torch.cli import kmeangrids
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.pipeline.bounce import (
        OverlaySpec,
        PipelineConfig,
        grid_cluster_stage,
        process_frames,
    )

    d = os.path.join(tmp, "overlay")
    os.makedirs(d)
    clip = os.path.join(d, "clip.avi")
    io_video.write_video_mjpg(clip, frames, 30.0)
    decoded = io_video.read_video_bgr(clip)
    n, h, w = decoded.shape[:3]
    n_boxes, n_polys = overlay_inputs(d, "clip.avi", n, h, w)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.chdir(d):
        lines, _ = run_cli(kmeangrids.main, ["-d", "OutImgs/clip", "-c", "1", "-f", "addnew.csv", "--path", clip,
                                             "--device", "cuda"])
    sync(dev)
    t_cli = time.perf_counter() - t0
    launches = kernels.flow_launches()
    cfg = PipelineConfig(flow=FarnebackParams(warp_mode="fast"))  # the CLI's default mode
    runs = flow_runs(n - 1, cfg.chunk, h, w, cfg.flow)
    check(launches == runs, f"overlay: expected launches {runs}, got {launches}")
    got = np.loadtxt(os.path.join(d, "OutCSV", "clip.csv"), delimiter=",", skiprows=1, dtype=np.int64, ndmin=2)
    plain = process_frames(decoded, cfg, dev)
    drawn = draw_overlays_on_host(plain["flow_bgr"], d, "clip.avi")
    want = grid_cluster_stage(drawn, GridParams(), True, dev)[1].cpu().numpy()
    check(got.shape == want.shape and np.array_equal(got, want),
          f"overlay: CLI table {got.shape} vs grid_cluster_stage over host-drawn overlays {want.shape}: "
          f"{int((got != want).sum()) if got.shape == want.shape else 'shapes differ'} cells differ")
    changed = int((plain["hue_table"] != want).sum())

    # The CLI and the plain run warmed both paths up; the overlay path's
    # first timed run also gives its frames for the byte check.
    spec = OverlaySpec("yolo_labels.txt", "Contours", "clip.avi")
    feature = dataclasses.replace(cfg, emit_flow_bgr=False)
    outs = {}
    runners = {"overlay path (flow_bgr returned)":
               lambda: outs.update(process_frames(decoded, cfg, dev, overlays=spec)),
               "feature-only process_frames": lambda: process_frames(decoded, feature, dev)}
    times = {k: [] for k in runners}
    with contextlib.chdir(d):
        for _ in range(REPEATS):
            for name, fn in runners.items():
                times[name].append(timed_s(dev, fn))
    diff = int((outs["flow_bgr"] != drawn).any(-1).sum())
    check(diff == 0 and np.array_equal(outs["hue_table"], want),
          f"overlay: the overlay path's frames differ from the host drawing in {diff} pixels, or its table does")
    print(f"overlay: kmeangrids with its default flags (overlays on) --device cuda on {n} frames {w}x{h} with "
          f"{n_boxes} boxes and {n_polys} polygons: {lines[-1]}; launches {launches} (design {runs}); table "
          f"bitwise equal to grid_cluster_stage over the host-drawn overlays ({changed} cells differ from "
          f"the table without overlays); the overlay path's {n - 1} frames byte-equal to the host drawing; "
          f"{t_cli:.2f} s with decode and CSVs {stamp}")
    for name, ts in times.items():
        print(f"time {name} {n}x{h}x{w} warp_mode=fast: {(n - 1) / float(np.median(ts)):.2f} pairs/s (median of "
              f"{REPEATS}, in turns, runs {', '.join(f'{t:.3f}' for t in ts)} s) {stamp}")
    return launches


def ops_phase(dev, stamp: str, frames: np.ndarray, tmp: str) -> None:
    """Phase 5s: the ops/ modules on the card at the clip's size, on its
    middle frame and on `circles_image`, each against the same function on
    the CPU: canny (L1, L2) bitwise, and its agreement with cv2.Canny;
    morphology, histogram counts and warp_perspective bitwise; SSIM and MSE
    within rtol 1e-5; Hough (both modes: the same circles, within 1e-3 px)
    and SLIC (share of equal labels ≥ 0.999) compared at OPS_CMP_HW, where
    the CPU is quick, and timed at the full size; the detectcircles and
    superpixels CLIs once each on the card. Prints each op's card time."""
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.cli import detectcircles, superpixels
    from opticalflowclustering_tpu_torch.ops import edges, histogram, hough, morphology, slic, ssim, warp
    from opticalflowclustering_tpu_torch.utils import profiling

    h, w = frames.shape[1:3]
    bgr = frames[len(frames) // 2]
    gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
    gray2 = cv2.cvtColor(frames[len(frames) // 2 + 1], cv2.COLOR_BGR2GRAY)
    circ = circles_image(h, w)
    on = {name: torch.from_numpy(a) for name, a in (("gray", gray), ("gray2", gray2), ("circ", circ), ("bgr", bgr))}
    card = {k: v.to(dev) for k, v in on.items()}
    ms = {}

    def both(name, fn, keys, equal):
        """fn on the card and on the CPU; `equal(card, cpu)` must hold; the
        card's time into ms[name]."""
        a = fn(*(card[k] for k in keys))
        b = fn(*(on[k] for k in keys))
        ok = equal(a, b)
        check(ok is True, f"{name}: card vs CPU {ok}")
        ms[name] = profiling.event_ms(lambda: fn(*(card[k] for k in keys)), 5)
        return a

    def same(a, b):
        a = a.cpu() if isinstance(a, torch.Tensor) else a
        return True if torch.equal(a, b) else f"not bitwise ({int((a != b).sum())} differ)"

    agree = []
    for img in ("gray", "circ"):
        for l2 in (False, True):
            e = both(f"canny {img} {'L2' if l2 else 'L1'}", lambda x, l2=l2: edges.canny(x, 50, 100, l2gradient=l2),
                     [img], same).cpu().numpy()
            ref = cv2.Canny(on[img].numpy(), 50, 100, L2gradient=l2)
            agree.append(f"{img} {'L2' if l2 else 'L1'} {float((e == ref).mean()):.6f}")
    k_rect, k_ell = morphology.structuring_element("rect", (21, 7)), morphology.structuring_element("ellipse", (9, 11))
    both("morphology close rect 21x7", lambda x: morphology.morphology_ex(x, "close", k_rect), ["gray"], same)
    both("dilate ellipse 9x11 x2", lambda x: morphology.dilate(x, k_ell, 2), ["gray"], same)
    both("calc_hist 8x8x8", lambda x: histogram.calc_hist(x, [0, 1, 2], [8, 8, 8], [(0, 256)] * 3), ["bgr"], same)
    m = warp.get_perspective_transform(np.float32([[0.08 * w, 0.1 * h], [0.92 * w, 0.05 * h], [0.95 * w, 0.97 * h],
                                                   [0.04 * w, 0.9 * h]]),
                                       np.float32([[0, 0], [w - 1, 0], [w - 1, h - 1], [0, h - 1]]))
    both("warp_perspective", lambda x: warp.warp_perspective(x, m, (w, h)), ["bgr"], same)

    def close(a, b):
        a, b = float(a), float(b)
        return True if abs(a - b) <= 1e-5 * abs(b) else f"{a} vs {b}"

    s = both("ssim", ssim.ssim, ["gray", "gray2"], close)
    both("mse", ssim.mse, ["gray", "gray2"], close)

    # Hough and SLIC: card vs CPU at OPS_CMP_HW, card times at full size.
    ch, cw = OPS_CMP_HW
    small = {"circ": circles_image(ch, cw), "gray": cv2.resize(gray, (cw, ch), interpolation=cv2.INTER_AREA)}
    found = []
    for gate in (True, False):
        mode = "coherent" if gate else "cv2-raw"
        for name, img in small.items():
            a = hough.hough_circles(torch.from_numpy(img).to(dev), coherence_gate=gate)
            b = hough.hough_circles(torch.from_numpy(img), coherence_gate=gate)
            check(a.shape == b.shape and np.allclose(a, b, atol=1e-3), f"hough {mode} {name} {cw}x{ch}: {a} vs {b}")
            found.append(f"{mode} {name} {len(a)}")
        full = hough.hough_circles(card["circ"], coherence_gate=gate)
        found.append(f"{mode} circles {w}x{h} {len(full)}")
        ms[f"hough_circles {mode} circles"] = profiling.event_ms(
            lambda gate=gate: hough.hough_circles(card["circ"], coherence_gate=gate), 3)
        ms[f"hough_circles {mode} frame"] = profiling.event_ms(
            lambda gate=gate: hough.hough_circles(card["gray"], coherence_gate=gate), 3)
    ref = cv2.HoughCircles(circ, cv2.HOUGH_GRADIENT, 1.2, 75)
    sb = torch.from_numpy(cv2.resize(bgr, (cw, ch), interpolation=cv2.INTER_AREA))
    labels = slic.slic(sb.to(dev)).cpu()
    share = float((labels == slic.slic(sb)).double().mean())
    check(share >= 0.999, f"slic {cw}x{ch}: card vs CPU labels equal on {share}")
    ms["slic 100 segments"] = profiling.event_ms(lambda: slic.slic(card["bgr"]), 3)

    d = os.path.join(tmp, "ops")
    os.makedirs(d)
    cv2.imwrite(os.path.join(d, "circles.png"), cv2.cvtColor(circ, cv2.COLOR_GRAY2BGR))
    cv2.imwrite(os.path.join(d, "frame.png"), bgr)
    cli = {}
    with contextlib.chdir(d):
        for name, main, argv in (("detectcircles", detectcircles.main, ["-i", "circles.png", "--device", "cuda"]),
                                 ("superpixels", superpixels.main, ["-i", "frame.png", "--segments", "100",
                                                                    "--device", "cuda"])):
            t0 = time.perf_counter()
            lines, _ = run_cli(main, argv)
            sync(dev)
            cli[name] = (lines, time.perf_counter() - t0)
    check(cli["detectcircles"][0][-2].endswith("circle(s) [coherent]") and os.path.isfile(
        os.path.join(d, "circles_circles.png")), f"detectcircles printed {cli['detectcircles'][0]}")
    check(cli["superpixels"][0][0].startswith("superpixels_100.png: ") and os.path.isfile(
        os.path.join(d, "superpixels_100.png")), f"superpixels printed {cli['superpixels'][0]}")
    print(f"ops {w}x{h}: canny, morphology, calc_hist, warp_perspective bitwise equal card vs CPU; ssim {float(s):.6f} "
          f"and mse within rtol 1e-5; canny agreement with cv2 {cv2.__version__}: {', '.join(agree)}; hough "
          f"(circles found: {', '.join(found)}; cv2.HoughCircles {0 if ref is None else ref.shape[1]}) the same "
          f"circles card vs CPU at {cw}x{ch}; slic labels equal card vs CPU at {cw}x{ch}: {share:.6f}")
    for name, (lines, t) in cli.items():
        print(f"{name} --device cuda: {' | '.join(lines)}; {t:.2f} s with PNG I/O {stamp}")
    print(f"time ops on the card, {w}x{h}, least of the runs (CUDA events): "
          f"{'; '.join(f'{k} {v:.3f} ms' for k, v in ms.items())} {stamp}")


def overlay_ops_phases(dev, stamp: str, frames: np.ndarray) -> dict:
    """Phases 5r-5s at the clip's size, each run with the kernel launch
    counts set to 0 just before it and read just after: the overlay path of
    kmeangrids (the design's launches, checked inside) and the ops/ modules
    with their CLIs (no hand-written kernel). Returns the launches by path."""
    import tempfile


    check(have_cv2(), "the overlay clip and the ops' CLIs need cv2, which is not importable")
    launches = {}
    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp:
        launches["overlay"] = overlay_phase(dev, stamp, frames, tmp)
        kernels.reset_launches()
        ops_phase(dev, stamp, frames, tmp)
        sync(dev)
        launches["ops"] = kernels.flow_launches()
    check(not any(launches["ops"].values()), f"ops launched {launches['ops']}")
    return launches


def spatial_runs(h: int, w: int, tp: int, params) -> dict:
    """Launches of one row-sharded flow: box_solve one per block, pyramid
    level and iteration, the poly expansion one per block, level and image
    (the batch goes in one launch), warp_m none, the pyramid kernel none
    (the blocks blur their halo-extended rows with the plain blur)."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan

    levels = len(pyramid_plan(h, w, params))
    return {"warp_m": 0, "box_solve": tp * levels * params.iterations, "gauss_solve": 0,
            "poly_expansion": tp * levels * 2, "pyramid": 0}


def spatial_phase(dev, stamp: str, frames: np.ndarray) -> dict:
    """Phase 5t: the row-sharded (spatial) flow at the clip's size on the
    reference's Farneback call (FarnebackParams(): 3 levels, winsize 15, 3
    iterations), over SPATIAL_PAIRS pairs of `frames`: box_solve bitwise
    equal to its plain version at the shapes of the blocks' M regions;
    spatial_hue_pipeline on a tp=2 mesh naming `dev` twice, its tables
    bitwise the unsharded exact pipeline's (farneback_flow →
    render_flow_hsv_bgr → grid) and its mean_mag within rtol 1e-6;
    spatial_farneback_flow on tp=2 within 5e-5 px of the unsharded flow
    (max |Δ| printed), and spatial_farneback_flow_padded on tp=4 (rows padded
    to the next multiple of 4·2^3) against the unsharded flow of the padded
    frames, cropped; each run's launches the design's (`spatial_runs`:
    box_solve blocks × levels × iterations, poly_expansion blocks × levels ×
    2, warp_m none). Times ms per pair of each beside the
    unsharded exact flow: on one card the blocks run in turn, so this is a
    check, not a speed-up. Returns the launches by path."""
    import torch

    from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
    from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow, pyramid_plan
    from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
    from opticalflowclustering_tpu_torch.ops.polar import magnitude
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.parallel.spatial import (
        spatial_farneback_flow,
        spatial_farneback_flow_padded,
        spatial_hue_pipeline,
    )
    from opticalflowclustering_tpu_torch.utils import profiling

    params, grid = FarnebackParams(), GridParams()
    gray = bgr2gray(torch.from_numpy(frames[: SPATIAL_PAIRS + 1]).to(dev))
    prev, nxt = gray[:-1], gray[1:]
    n, h, w = prev.shape
    mhalf = params.winsize // 2
    gen = torch.Generator(device=dev).manual_seed(1)
    for tp in (2, 4):
        h_loc = -(-h // (tp * 2**params.levels)) * 2**params.levels
        for k, _, w_k, _ in pyramid_plan(h, w, params):
            m = torch.randn(n, 5, h_loc // 2**k + 2 * mhalf, w_k, generator=gen, device=dev) * 10
            check(all(torch.equal(a, b) for a, b in zip(kw.box_solve(m, params.winsize),
                                                        kw.box_solve_reference(m, params.winsize))),
                  f"box_solve [{n},5,{m.shape[2]},{w_k}]: not bitwise")
    print(f"check box_solve at the M-region shapes of the tp=2 and tp=4 blocks: bitwise equal to the plain version")

    mesh2 = make_mesh({"tp": 2}, [dev] * 2)
    mesh4 = make_mesh({"tp": 4}, [dev] * 4)
    launches = {}

    def counted(name, fn):
        kernels.reset_launches()
        out = fn()
        sync(dev)
        launches[name] = kernels.flow_launches()
        return out

    got = counted("spatial_hue_tp2", lambda: spatial_hue_pipeline(prev, nxt, mesh2, "tp", grid, params))
    flow = farneback_flow(prev, nxt, params)
    bgr = render_flow_hsv_bgr(flow)
    cen, hue = dominant_hue_k1_frames(bgr, grid)
    want = {"hue_table": hue, "rgb_hue_table": grid_mean_hue(bgr, grid), "centroids": cen,
            "mean_magnitude": magnitude(flow[..., 0], flow[..., 1]).mean(dim=(-2, -1))}
    rel = check_tables({k: t.cpu().numpy() for k, t in zip(want, got)}, {k: t.cpu().numpy() for k, t in want.items()},
                       "spatial_hue_pipeline tp=2 vs unsharded")
    tp_flow = counted("spatial_flow_tp2", lambda: spatial_farneback_flow(prev, nxt, mesh2, "tp", params))
    diff = float((tp_flow - flow).abs().max())
    check(diff <= 5e-5, f"spatial flow tp=2: max |Δ| {diff} px from the unsharded flow")
    pad = (-h) % (4 * 2**params.levels)

    def padded(g):
        return torch.cat([g, g[:, -1:].expand(n, pad, w)], dim=1)

    pad_flow = counted("spatial_padded_tp4", lambda: spatial_farneback_flow_padded(prev, nxt, mesh4, "tp", params))
    pad_want = farneback_flow(padded(prev), padded(nxt), params)[:, :h]
    pad_diff = float((pad_flow - pad_want).abs().max())
    check(tuple(pad_flow.shape) == (n, h, w, 2) and pad_diff <= 5e-5,
          f"padded spatial flow tp=4: {tuple(pad_flow.shape)}, max |Δ| {pad_diff} px")
    design = {"spatial_hue_tp2": spatial_runs(h, w, 2, params), "spatial_flow_tp2": spatial_runs(h, w, 2, params),
              "spatial_padded_tp4": spatial_runs(h + pad, w, 4, params)}
    for name, runs in design.items():
        check(launches[name] == runs, f"{name}: expected launches {runs}, got {launches[name]}")
    print(f"spatial {n} pairs {w}x{h}, FarnebackParams() ({len(pyramid_plan(h, w, params))} levels): "
          f"spatial_hue_pipeline on a tp=2 mesh of {dev}: tables bitwise equal to the unsharded pipeline's "
          f"(mean_magnitude rel diff {rel:.3g}); spatial flow tp=2 max |Δ| {diff:.3g} px, padded tp=4 "
          f"({h + pad} rows) max |Δ| {pad_diff:.3g} px; launches {launches} (design {design})")
    ms = {"unsharded exact farneback_flow": profiling.event_ms(lambda: farneback_flow(prev, nxt, params), REPEATS),
          "spatial_farneback_flow tp=2": profiling.event_ms(
              lambda: spatial_farneback_flow(prev, nxt, mesh2, "tp", params), REPEATS),
          "spatial_farneback_flow_padded tp=4": profiling.event_ms(
              lambda: spatial_farneback_flow_padded(prev, nxt, mesh4, "tp", params), REPEATS),
          "spatial_hue_pipeline tp=2": profiling.event_ms(
              lambda: spatial_hue_pipeline(prev, nxt, mesh2, "tp", grid, params), REPEATS)}
    print(f"time spatial, {n} pairs {w}x{h}, ms per pair, least of {REPEATS} (CUDA events; the blocks of one card "
          f"run in turn): {'; '.join(f'{k} {v / n:.3f}' for k, v in ms.items())} {stamp}")
    return launches


def dryrun_phase(dev, stamp: str) -> dict:
    """Phase 5u: warp_m within 1e-4/1e-3 of its plain version and box_solve
    bitwise equal to its own at the level shapes of pass 1.75's 512x128
    'fast' pyramid, for a dp x sp block's 2 pairs and the unsharded flow's 8;
    then graft_entry.dryrun_multichip(4) on a mesh naming `dev` four
    times (each pass's line and launches printed by it), each pass's
    launches held against the design (the spatial passes box_solve only,
    pass 1.75's 'fast' flow both kernels, the levels=1 exact passes none);
    then entry()'s forward at 720p, its tables bitwise equal to
    process_frames' over the same frames. Returns the launches by path."""
    import torch

    from opticalflowclustering_tpu_torch import graft_entry
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, pyramid_plan
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames

    fast = FarnebackParams(warp_mode="fast")
    gen = torch.Generator(device=dev).manual_seed(3)
    err, shapes = 0.0, []
    for b in (2, 8):
        for _, h_k, w_k, _ in pyramid_plan(512, 128, fast):
            r0, r1 = (torch.randn(b, 5, h_k, w_k, generator=gen, device=dev) * 10 for _ in range(2))
            fx, fy = (torch.randn(b, h_k, w_k, generator=gen, device=dev) * 3 for _ in range(2))
            m = kw.warp_m(r0, r1, fx, fy)
            want = kw.warp_m_reference(r0, r1, fx, fy)
            e = float((m - want).abs().max())
            err = max(err, e)
            check(torch.allclose(m, want, rtol=1e-4, atol=1e-3), f"warp_m [{b},5,{h_k},{w_k}]: max abs err {e}")
            check(all(torch.equal(a, c) for a, c in zip(kw.box_solve(m, fast.winsize),
                                                        kw.box_solve_reference(m, fast.winsize))),
                  f"box_solve [{b},5,{h_k},{w_k}]: not bitwise")
            shapes.append(f"[{b},5,{h_k},{w_k}]")
    print(f"check warp_m (max abs err {err:.3g}) and box_solve (bitwise) at the 512x128 'fast' level shapes "
          f"{' '.join(shapes)}: equal to the plain versions")

    t0 = time.perf_counter()
    got = graft_entry.dryrun_multichip(4, devices=[dev] * 4)
    t = time.perf_counter() - t0
    one, sp1 = FarnebackParams(levels=1), FarnebackParams(levels=1, warp_radius=8)

    def tp4(h):  # the 4-block row-sharded flow of h×96 and the unsharded flow it is held to
        return add_runs(spatial_runs(h, 96, 4, sp1), flow_runs(1, 1, h, 96, sp1))

    # passes 1 and 1.75: 4 blocks, then the unsharded flow; pass 2: 4 blocks
    design = {"1": flow_runs(1, 1, 64, 96, one, 5), "1.5": tp4(192), "1.6": tp4(720), "1.7": tp4(192),
              "1.75": flow_runs(1, 1, 512, 128, fast, 5), "2": flow_runs(1, 1, 64, 96, one, 4)}
    for name, runs in design.items():
        check(got[name] == runs, f"dryrun pass {name}: expected launches {runs}, got {got[name]}")
    print(f"dryrun_multichip(4) on a mesh of {dev} x4: six passes ok, launches as designed; {t:.2f} s {stamp}")

    fn, (frames,) = graft_entry.entry(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = fn(frames)
    sync(dev)
    t = time.perf_counter() - t0
    launches = kernels.flow_launches()
    cfg = PipelineConfig(chunk=4, emit_flow_bgr=False)
    want = process_frames(frames, cfg, dev)
    check([tuple(o.shape) for o in out] == [(4, 350), (4, 350), (4,)], f"entry shapes {[o.shape for o in out]}")
    check(all(bool(torch.isfinite(o.float()).all()) for o in out), "entry: non-finite output")
    for o, k in zip(out, ("hue_table", "rgb_hue_table", "mean_magnitude")):
        check(np.array_equal(o.cpu().numpy(), want[k]), f"entry {k} differs from process_frames'")
    runs = flow_runs(frames.shape[0] - 1, cfg.chunk, frames.shape[1], frames.shape[2], cfg.flow)
    check(launches == runs, f"entry (exact flow): expected launches {runs}, got {launches}")
    print(f"entry() forward, {frames.shape[0]} frames {frames.shape[2]}x{frames.shape[1]}, exact flow: tables equal "
          f"to process_frames'; launches {launches}; {t * 1e3:.1f} ms {stamp}")
    return {f"dryrun_{k}": v for k, v in got.items()} | {"entry": launches}


def quad_image(h: int, w: int, seed: int, fill=(235, 235, 235), ground=35) -> np.ndarray:
    """[h, w, 3] uint8: a light quadrilateral, rotated by a seeded angle,
    with a few dark lines of "text" on a dark, slightly noisy ground (the
    document the scanner looks for; also a Game Boy screen)."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.clip(ground + rng.normal(0, 4, (h, w, 3)), 0, 255).astype(np.uint8)
    rect = ((w / 2 + rng.uniform(-0.05, 0.05) * w, h / 2 + rng.uniform(-0.05, 0.05) * h),
            (0.55 * w, 0.75 * h), float(rng.uniform(-12, 12)))
    quad = cv2.boxPoints(rect).round().astype(np.int32)
    cv2.fillPoly(img, [quad], fill)
    for i in range(4):
        y = int(h * (0.35 + 0.08 * i))
        cv2.line(img, (int(0.38 * w), y), (int(0.62 * w), y), (20, 20, 20), max(2, h // 180))
    return img


def extras_phase(dev, stamp: str, frames: np.ndarray, tmp: str) -> None:
    """Phase 5v: the extras at the clip's size, card against CPU: the scan
    CLI (--device cuda vs cpu) on a seeded 1280x720 `quad_image` (the same
    lines, byte-equal PNGs), the searchengine CLI's index and search over 32
    seeded 166x100 images (the same lines, features within rtol 1e-6),
    color_transfer of two frames (at most 1e-3 of the BGR codes apart, the
    LAB gap), skin_mask, locate_barcode (bars drawn on a frame) and
    brightest_spot bitwise (its gray within rtol 1e-6), find_screen on
    another quad image bitwise and the Zernike descriptor of its
    sprite_outline within rtol 1e-5. Prints each one's least ms on the card
    over REPEATS calls (CUDA events, host work included)."""
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.cli import scan, searchengine
    from opticalflowclustering_tpu_torch.extras import color_transfer, detectors, document_scanner, pokedex
    from opticalflowclustering_tpu_torch.extras.search_engine import index_images
    from opticalflowclustering_tpu_torch.utils import profiling

    h, w = frames.shape[1:3]
    d = os.path.join(tmp, "extras")
    os.makedirs(os.path.join(d, "photos"))
    ms, notes = {}, []

    doc = quad_image(h, w, 0)
    cv2.imwrite(os.path.join(d, "doc.png"), doc)
    with contextlib.chdir(d):
        lines = {where: run_cli(scan.main, ["-i", "doc.png", "-o", where, "--device", where])[0]
                 for where in ("cuda", "cpu")}
        check(lines["cuda"][0].startswith("wrote cuda_warped.png") and
              [ln.replace("cuda", "cpu") for ln in lines["cuda"]] == lines["cpu"], f"scan printed {lines}")
        for suffix in ("_warped.png", "_binarized.png"):
            with open("cuda" + suffix, "rb") as a, open("cpu" + suffix, "rb") as b:
                check(a.read() == b.read(), f"scan {suffix}: card and CPU files differ")
        notes.append(f"scan: {lines['cuda'][0]}, PNGs byte-equal to the CPU run's")
        ms["scan_document"] = profiling.event_ms(lambda: document_scanner.scan_document(doc, device=dev), REPEATS)

        rng = np.random.default_rng(0)
        for i in range(32):
            cv2.imwrite(os.path.join("photos", f"p{i:02d}.png"), rng.integers(0, 256, (100, 166, 3), dtype=np.uint8))
        for where in ("cuda", "cpu"):
            lines[where] = (run_cli(searchengine.main, ["index", "-d", "photos", "-i", f"{where}.npz",
                                                         "--device", where])[0]
                            + run_cli(searchengine.main, ["search", "-i", f"{where}.npz", "-q", "photos/p07.png",
                                                          "-k", "5", "--device", where])[0])
        a, b = np.load("cuda.npz"), np.load("cpu.npz")
        check(lines["cuda"][0] == "indexed 32 images -> cuda.npz" and lines["cuda"][1:] == lines["cpu"][1:]
              and lines["cuda"][1].endswith("\tp07.png"), f"searchengine printed {lines}")
        np.testing.assert_allclose(a["features"], b["features"], rtol=1e-6, atol=1e-9, err_msg="searchengine index")
        notes.append(f"searchengine: index of 32 and search -k 5 print the CPU run's lines ({lines['cuda'][1]!r} "
                     f"first)")
        imgs = np.stack([cv2.imread(os.path.join("photos", f"p{i:02d}.png")) for i in range(32)])
        ms["index_images 32x166x100"] = profiling.event_ms(lambda: index_images(imgs, device=dev), REPEATS)

    src, tar = frames[len(frames) // 3], frames[2 * len(frames) // 3]
    card = color_transfer.color_transfer(src, tar, device=dev).cpu().numpy()
    cpu = color_transfer.color_transfer(src, tar, device="cpu").numpy()
    gap = np.abs(card.astype(np.int16) - cpu.astype(np.int16))
    share = float((gap > 0).mean())
    check(card.shape == tar.shape and share <= 1e-3, f"color_transfer: {share} of the codes differ card vs CPU")
    notes.append(f"color_transfer: {int((gap > 0).sum())} of {gap.size} codes differ card vs CPU (largest gap "
                 f"{int(gap.max())}; tolerance a share of 1e-3)")
    ms["color_transfer"] = profiling.event_ms(lambda: color_transfer.color_transfer(src, tar, device=dev), REPEATS)

    frame = frames[len(frames) // 2]
    skin = frame.copy()
    skin[h // 4 : h // 2, w // 4 : w // 2] = (120, 150, 200)  # a skin-toned patch (hue ~10)
    a = detectors.skin_mask(skin, device=dev).cpu()
    check(torch.equal(a, detectors.skin_mask(skin, device="cpu")) and bool(a.any()), "skin_mask: card vs CPU")
    ms["skin_mask"] = profiling.event_ms(lambda: detectors.skin_mask(skin, device=dev), REPEATS)
    bars = frame.copy()  # tests/test_extras.py's barcode: 2-px bars every 4 px on white, softened
    cv2.rectangle(bars, (w // 3 - 8, h // 3 - 8), (2 * w // 3 + 8, 2 * h // 3 + 8), (255, 255, 255), -1)
    for x in range(w // 3, 2 * w // 3, 4):
        cv2.rectangle(bars, (x, h // 3), (x + 1, 2 * h // 3), (0, 0, 0), -1)
    bars = cv2.GaussianBlur(bars, (3, 3), 0)
    box = detectors.locate_barcode(bars, device=dev)
    check(box.shape == (4, 2) and np.array_equal(box, detectors.locate_barcode(bars, device="cpu")),
          f"locate_barcode: card {box.tolist()} vs CPU")
    ms["locate_barcode"] = profiling.event_ms(lambda: detectors.locate_barcode(bars, device=dev), REPEATS)
    for radius in (0, 41):
        (xy, g), (cxy, cg) = (detectors.brightest_spot(frame, radius, device=where) for where in (dev, "cpu"))
        check(xy == cxy and torch.allclose(g.cpu(), cg, rtol=1e-6, atol=1e-4), f"brightest_spot r={radius}: {xy} {cxy}")
        ms[f"brightest_spot r={radius}"] = profiling.event_ms(
            lambda r=radius: detectors.brightest_spot(frame, r, device=dev), REPEATS)
    notes.append(f"skin_mask, locate_barcode (box {box.tolist()}) and brightest_spot ({xy}) equal card vs CPU")

    screen_img = quad_image(h, w, 1, fill=(150, 190, 140))
    screen = pokedex.find_screen(screen_img, device=dev)
    check(screen is not None and np.array_equal(screen, pokedex.find_screen(screen_img, device="cpu")),
          "find_screen: card vs CPU")
    ms["find_screen"] = profiling.event_ms(lambda: pokedex.find_screen(screen_img, device=dev), REPEATS)
    outline = pokedex.sprite_outline(255 - screen, device=dev)
    desc = pokedex.ZernikeMoments(21, device=dev).describe(outline)
    want = pokedex.ZernikeMoments(21, device="cpu").describe(pokedex.sprite_outline(255 - screen, device="cpu"))
    np.testing.assert_allclose(desc, want, rtol=1e-5, atol=1e-6, err_msg="Zernike descriptor card vs CPU")
    notes.append(f"find_screen: a {screen.shape[1]}x{screen.shape[0]} screen equal card vs CPU, its Zernike "
                 f"descriptor within rtol 1e-5")
    print(f"extras {w}x{h}: {'; '.join(notes)}")
    print(f"time extras on the card, {w}x{h}, least of {REPEATS} (CUDA events, host work included): "
          f"{'; '.join(f'{k} {v:.2f} ms' for k, v in ms.items())} {stamp}")


def spatial_dryrun_extras_phases(dev, stamp: str, frames: np.ndarray) -> dict:
    """Phases 5t-5v: the spatial flow, the dryrun entry and the extras at the
    clip's size, each run with the kernel launch counts set to 0 just before
    it and read just after and held against its design (the extras launch
    no kernel). Returns the launches by path."""
    import tempfile


    check(have_cv2(), "the extras' CLIs and images need cv2, which is not importable")
    launches = spatial_phase(dev, stamp, frames)
    launches.update(dryrun_phase(dev, stamp))
    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp:
        kernels.reset_launches()
        extras_phase(dev, stamp, frames, tmp)
        sync(dev)
        launches["extras"] = kernels.flow_launches()
    check(not any(launches["extras"].values()), f"extras launched {launches['extras']}")
    return launches


def select_phase(dev, stamp: str, frames: np.ndarray) -> dict:
    """Phase 5w: the legacy 'select' warp (FarnebackParams(warp_mode=
    'select'), warp_radius 32), which runs warp_m and box_solve on no
    device (its poly expansion is the kernel's, as in every mode). On 4
    pairs of `frames` and 4 pairs of real footage (demo_out/601_3.avi frames
    30-34): the card's flow within mean EPE SELECT_CARD_CPU_EPE of the
    port's CPU flow of the same pairs (the bound of the card-vs-CPU check of
    phase 4), the launches `flow_runs` gives 'select' (the poly kernel
    alone), and the mean EPE against the
    exact flow and against cv2.calcOpticalFlowFarneback printed (not gated:
    'select' is inexact by contract). Then process_frames in 'select' and
    'fast' over `frames`, in turns, median of REPEATS: pairs/s of each and
    the peak allocated device memory of each, the 'select' runs launching
    no warp_m or box_solve. Returns the launches by path."""
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames

    select = FarnebackParams(warp_mode="select")
    clips = {"synthetic": (f"synthetic {frames.shape[2]}x{frames.shape[1]}", frames[:5]),
             "demo": ("demo_out/601_3.avi 220x232", io_video.read_video_bgr("demo_out/601_3.avi", 35)[30:35])}
    launches = {}

    def epe(a, b):
        return float(torch.linalg.vector_norm(a - b, dim=-1).mean())

    for key, (name, clip) in clips.items():
        gray = bgr2gray(torch.from_numpy(clip))
        g = gray.to(dev)
        kernels.reset_launches()
        got = farneback_flow(g[:-1], g[1:], select)
        sync(dev)
        path = f"select_flow_{key}"
        launches[path] = kernels.flow_launches()
        runs = flow_runs(4, 4, *g.shape[1:], select)
        check(launches[path] == runs, f"select flow {name} launched {launches[path]}, expected {runs}")
        got = got.cpu()
        cpu = farneback_flow(gray[:-1], gray[1:], select)
        e_cpu = epe(got, cpu)
        check(bool(torch.isfinite(got).all()) and e_cpu <= SELECT_CARD_CPU_EPE,
              f"select flow {name}: card vs CPU mean EPE {e_cpu} (bound {SELECT_CARD_CPU_EPE})")
        exact = farneback_flow(g[:-1], g[1:], FarnebackParams(warp_mode="exact")).cpu()
        want = torch.from_numpy(np.stack([cv2.calcOpticalFlowFarneback(
            gray[i].numpy(), gray[i + 1].numpy(), None, 0.5, 3, 15, 3, 5, 1.2, 0) for i in range(4)]))
        print(f"select flow, 4 pairs of {name} (max |flow| {float(got.abs().max()):.1f} px): card vs CPU mean EPE "
              f"{e_cpu:.3g} px (bound {SELECT_CARD_CPU_EPE:g}), bitwise {torch.equal(got, cpu)}; launches "
              f"{launches[path]}; mean EPE, not gated: vs exact {epe(got, exact):.3g} px, vs cv2 "
              f"{cv2.__version__} {epe(got, want):.3g} px {stamp}")

    cfgs = {m: PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode=m)) for m in ("select", "fast")}
    kernels.reset_launches()
    out = process_frames(frames, cfgs["select"], device=dev)  # also the warm-up
    sync(dev)
    launches["select_process_frames"] = kernels.flow_launches()
    n_pairs = frames.shape[0] - 1
    runs = flow_runs(n_pairs, cfgs["select"].chunk, *frames.shape[1:3], select)
    check(launches["select_process_frames"] == runs,
          f"select process_frames launched {launches['select_process_frames']}, expected {runs}")
    check(out["hue_table"].shape == (n_pairs, 350) and np.isfinite(out["mean_magnitude"]).all()
          and float(out["mean_magnitude"].max()) > 0.01, "select process_frames: tables wrong or no motion")
    process_frames(frames, cfgs["fast"], device=dev)
    times, peak = {m: [] for m in cfgs}, {}
    for _ in range(REPEATS):
        for m, cfg in cfgs.items():
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            times[m].append(timed_s(dev, lambda cfg=cfg: process_frames(frames, cfg, device=dev)))
            if dev.type == "cuda":
                peak[m] = max(peak.get(m, 0), torch.cuda.max_memory_allocated(dev))
    parts = []
    for m, ts in times.items():
        mem = f"{peak[m] / 2**30:.3f} GiB" if m in peak else "not measured (no card)"
        parts.append(f"{m} {n_pairs / float(np.median(ts)):.2f} pairs/s (runs {', '.join(f'{t:.3f}' for t in ts)} s; "
                     f"peak allocated {mem})")
    print(f"time process_frames {frames.shape[0]}x{frames.shape[1]}x{frames.shape[2]} chunk 16, tables only, median "
          f"of {REPEATS} in turns: {'; '.join(parts)}; select launches {launches['select_process_frames']} {stamp}")
    return launches


def cell_points(flow_bgr, grid):
    """Every grid cell of the [n, H, W, 3] uint8 frames (a tensor), cut to
    its top-left 50×50 crop (smaller where the grid step is), through
    the RGBA preprocess of the k-means path → [n·cells, cell², 4] float32 on
    the frames' device."""
    import torch

    from opticalflowclustering_tpu_torch.features.dominant_color import preprocess_cells_rgba

    n, h, w = flow_bgr.shape[:3]
    ys, xs = grid.steps(h, w)
    c = min(50, ys, xs)
    f = flow_bgr[:, : grid.rows * ys, : grid.cols * xs].reshape(n, grid.rows, ys, grid.cols, xs, 3)
    cells = f[:, :, :c, :, :c].permute(0, 1, 3, 2, 4, 5).reshape(-1, c, c, 3)
    return preprocess_cells_rgba(cells, rb_swap=True).reshape(cells.shape[0], c * c, 4).to(torch.float32)


def kmeans_phase(dev, stamp: str, flow_bgr: np.ndarray) -> None:
    """Phase 5f: kmeans_batched at k=3, n_iter 30 over every cell of the
    rendered flow frames (RGBA, 50×50 crops; at 720p 48 × 350 = 16,800
    cells, 168 M floats), timed on the card as cells/s; and the Lloyd loop
    on a spread subset of the cells run on the CPU from the same ++ centres:
    each cell's inertia within rel 1e-4, labels agreeing on ≥ 99.9%. The
    inertia is Σ‖x − c(x)‖² of each side's centres and labels, summed in
    float64 (the expanded ‖x‖² − 2x·c + ‖c‖² that assigns the labels
    cancels to within ~0.02 of 0 at pixel values ~255, which is most of a
    nearly flat cell's inertia)."""
    import torch

    from opticalflowclustering_tpu_torch.cluster import kmeans as km
    from opticalflowclustering_tpu_torch.features.grid import GridParams

    x = cell_points(torch.from_numpy(flow_bgr).to(dev), GridParams())
    b, p, _ = x.shape
    check(b == flow_bgr.shape[0] * 350, f"k-means cells {tuple(x.shape)}")
    centers, labels = km.kmeans_batched(x, 3, torch.Generator().manual_seed(0))  # warm-up
    times = []
    for _ in range(REPEATS):
        times.append(timed_s(dev, lambda: km.kmeans_batched(x, 3, torch.Generator().manual_seed(0))))
    check(tuple(centers.shape) == (b, 3, 4) and tuple(labels.shape) == (b, p), "kmeans_batched shapes")
    check(bool(torch.isfinite(centers).all()), "kmeans_batched: non-finite centres")
    # kmeans_batched drew these ++ centres from the same seed.
    init = km._plusplus_init(x, 3, torch.Generator().manual_seed(0))
    sub = torch.arange(0, b, max(b // 512, 1), device=dev)
    xs = x[sub].cpu()
    c_cpu, l_cpu, _ = km._lloyd(xs, init[sub].cpu(), 30)

    def inertia(c, lab):
        own = torch.gather(c.double(), 1, lab[..., None].expand(-1, -1, xs.shape[-1]))
        return ((xs.double() - own) ** 2).sum(dim=(-2, -1))

    jc, jg = inertia(c_cpu, l_cpu), inertia(centers[sub].cpu(), labels[sub].cpu())
    rel = float(((jg - jc).abs() / jc.clamp_min(1.0)).max())
    agree = float((labels[sub].cpu() == l_cpu).double().mean())
    check(rel <= 1e-4, f"k-means inertia card vs CPU: max rel diff {rel}")
    check(agree >= 0.999, f"k-means labels card vs CPU agree on {agree}")
    t = float(np.median(times))
    print(f"kmeans_batched k=3 n_iter=30 over {b} cells x {p} px x 4 ({b * p * 4 / 1e6:.1f} M floats): "
          f"card vs CPU on {len(sub)} cells from the same ++ centres: max inertia rel diff {rel:.3g} "
          f"(tolerance 1e-4), labels agree {agree:.6f} (tolerance 0.999)")
    print(f"time kmeans_batched {b} cells: {b / t:.1f} cells/s ({t * 1e3:.1f} ms, median of {REPEATS}, "
          f"runs {', '.join(f'{v * 1e3:.1f}' for v in times)} ms) {stamp}")


def quantize_phase(dev, stamp: str, frame: np.ndarray) -> None:
    """Phase 5g: quantize_colors on one frame at k=8, both methods, on the
    card and on the CPU with the same draws: ≤ 0.1% of pixels more than 3
    codes apart. A float rounding may move a centre across a rounding
    boundary (its pixels then differ by a code or two after lab2bgr) or a
    pixel to another centre at a near-tie (that pixel differs by more).
    Each is timed on the card. Then the count of bgr2lab codes that differ
    between the card and the CPU over 2^20 seeded pixels (printed)."""
    import torch

    from opticalflowclustering_tpu_torch.extras.quantize import quantize_colors
    from opticalflowclustering_tpu_torch.ops.lab import bgr2lab

    h, w = frame.shape[:2]
    img = torch.from_numpy(frame)
    for method in ("lloyd", "minibatch"):
        def run(src, m=method):
            return quantize_colors(src, 8, torch.Generator().manual_seed(0), method=m)

        card = run(img.to(dev)).cpu().numpy()
        cpu = run(img).numpy()
        gap = np.abs(card.astype(np.int16) - cpu.astype(np.int16)).max(-1)
        same, far = float((gap == 0).mean()), float((gap > 3).mean())
        colours = len(np.unique(card.reshape(-1, 3), axis=0))
        check(card.shape == frame.shape and colours <= 8, f"quantize {method}: {card.shape}, {colours} colours")
        check(far <= 1e-3, f"quantize {method}: card vs CPU pixels more than 3 codes apart {far}")
        times = [timed_s(dev, lambda: run(img.to(dev))) for _ in range(REPEATS)]
        t = float(np.median(times))
        print(f"quantize_colors {w}x{h} k=8 method={method}: {colours} colours; card vs CPU pixels equal "
              f"{same:.6f}, more than 3 codes apart {far:.6f} (tolerance 0.001), largest gap {int(gap.max())}; time {t * 1e3:.1f} ms ({h * w / t / 1e6:.1f} Mpx/s, median of "
              f"{REPEATS}) {stamp}")
    # The LAB step quantize runs first: its codes on the card against the CPU's.
    x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1 << 20, 3), dtype=np.uint8))
    gap = (bgr2lab(x.to(dev)).cpu().int() - bgr2lab(x).int()).abs()
    print(f"bgr2lab card vs CPU over 2^20 seeded BGR pixels: {int((gap > 0).sum())} of {gap.numel()} codes "
          f"differ, largest gap {int(gap.max())}")


def run_cli(main, argv):
    """`main(argv)` of a CLI in-process: (its printed lines, what it returned)."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue().splitlines(), result


def colorkmeans_phase(dev, stamp: str, flow_bgr: np.ndarray, tmp: str) -> None:
    """Phase 5h: the colorkmeans CLI (`-d`, --device cuda) over a directory of
    50×50 PNG cells cut from the rendered flow frames, at k=1 and k=3,
    against the same CLI on the CPU: k=1 CSVs byte-equal; k=3 (same ++
    draws, card vs CPU Lloyd) every centroid channel within 2 (a centre
    near .5 may round the other way)."""
    import cv2

    from opticalflowclustering_tpu_torch.cli import colorkmeans
    from opticalflowclustering_tpu_torch.features.grid import GridParams

    n = min(flow_bgr.shape[0], 4)
    h, w = flow_bgr.shape[1:3]
    ys, xs = GridParams().steps(h, w)
    c = min(50, ys, xs)
    d = os.path.join(tmp, "cells")
    os.makedirs(d)
    k = 0
    for f in flow_bgr[:n]:
        for r in range(GridParams().rows):
            for q in range(GridParams().cols):
                k += 1
                cv2.imwrite(os.path.join(d, f"{k}.png"), f[r * ys : r * ys + c, q * xs : q * xs + c])
    for clusters in (1, 3):
        csv = {name: os.path.join(tmp, f"ckm{clusters}_{name}.csv") for name in ("cuda", "cpu")}
        t0 = time.perf_counter()
        lines, _ = run_cli(colorkmeans.main, ["-d", d, "-c", str(clusters), "-f", csv["cuda"], "--device", "cuda"])
        t = time.perf_counter() - t0
        ref, _ = run_cli(colorkmeans.main, ["-d", d, "-c", str(clusters), "-f", csv["cpu"], "--device", "cpu"])
        check(len(lines) == k, f"colorkmeans k={clusters} printed {len(lines)} rows")
        if clusters == 1:
            with open(csv["cuda"], "rb") as a, open(csv["cpu"], "rb") as b:
                check(a.read() == b.read(), "colorkmeans k=1: card and CPU CSVs differ")
            same = "CSV byte-equal to the CPU run's"
        else:
            def cents(rows):
                return np.array([[float(v) for v in r.split("[")[1].split("]")[0].split()] for r in rows])

            gap = float(np.abs(cents(lines) - cents(ref)).max())
            check(gap <= 2, f"colorkmeans k=3: centroid channels differ by {gap}")
            same = f"{sum(a == b for a, b in zip(lines, ref))}/{k} rows equal to the CPU run's, largest centroid gap {gap:g}"
        print(f"colorkmeans -d ({k} PNG cells {c}x{c}) -c {clusters} --device cuda: {same}; "
              f"{t:.2f} s with decode and CSV {stamp}")


def serving_phase(dev, stamp: str, flow_bgr: np.ndarray, tmp: str) -> None:
    """Phase 5i: FlowCellNet serving. detect_windows over each rendered flow
    frame at stride 25 (at 720p 1,350 windows in one batched forward per
    frame), timed as windows/s; on three frames the window probabilities
    within 1e-5 of the CPU model's and the boxes equal (confidence 0.9 and
    0.5); then the classify, detect and realtime CLIs with --device cuda."""
    import cv2
    import torch

    from opticalflowclustering_tpu_torch.cli import classify, detect, realtime
    from opticalflowclustering_tpu_torch.models import flow_cnn

    model = flow_cnn.load_params(device=dev)
    ref = flow_cnn.load_params(device="cpu")
    frames = torch.from_numpy(flow_bgr).to(dev)
    n = frames.shape[0]
    ys, xs, _ = flow_cnn._window_probs(model, frames[0])  # warm-up
    windows = len(ys) * len(xs)
    t = timed_s(dev, lambda: [flow_cnn._window_probs(model, f) for f in frames])
    t_det = timed_s(dev, lambda: [flow_cnn.detect_windows(model, f) for f in flow_bgr])
    worst, boxes = 0.0, 0
    for i in sorted({0, n // 2, n - 1}):
        got = flow_cnn._window_probs(model, frames[i])[2].cpu()
        want = flow_cnn._window_probs(ref, flow_bgr[i])[2]
        worst = max(worst, float((got - want).abs().max()))
        for conf in (0.9, 0.5):
            a = flow_cnn.detect_windows(model, flow_bgr[i], confidence=conf)
            b = flow_cnn.detect_windows(ref, flow_bgr[i], confidence=conf)
            check([x[2] for x in a] == [x[2] for x in b], f"detect frame {i} conf {conf}: boxes differ")
            boxes += len(a)
    check(worst <= 1e-5, f"FlowCellNet window probabilities card vs CPU: max abs diff {worst}")
    print(f"detect_windows {n} frames of {flow_bgr.shape[2]}x{flow_bgr.shape[1]}, {windows} windows each: "
          f"card vs CPU on 3 frames: probabilities max abs diff {worst:.3g} (tolerance 1e-5), boxes equal "
          f"({boxes} boxes at confidence 0.9 and 0.5)")
    print(f"time FlowCellNet windows {n} x {windows}: {n * windows / t:.0f} windows/s ({t / n * 1e3:.2f} ms "
          f"per frame); detect_windows with the host NMS {n / t_det:.1f} frames/s {stamp}")

    cell, frame_png, out_png = (os.path.join(tmp, x) for x in ("cell.png", "frame.png", "annotated.png"))
    cv2.imwrite(cell, flow_bgr[0, :50, :50])
    cv2.imwrite(frame_png, flow_bgr[0])
    got, _ = run_cli(classify.main, ["-i", cell, "--device", "cuda"])
    want, _ = run_cli(classify.main, ["-i", cell, "--device", "cpu"])
    check(got[0].startswith("[INFO] classification took ") and [g.split(", probability")[0] for g in got[1:]]
          == [w.split(", probability")[0] for w in want[1:]], f"classify printed {got}")
    got, _ = run_cli(detect.main, ["-i", frame_png, "-c", "0.5", "-o", out_png, "--device", "cuda"])
    want, _ = run_cli(detect.main, ["-i", frame_png, "-c", "0.5", "--device", "cpu"])

    def parsed(lines):
        return [(x.rsplit(": ", 1)[0], float(x.rsplit(": ", 1)[1].rstrip("%"))) for x in lines]

    check(len(got) == len(want) and all(a[0] == b[0] and abs(a[1] - b[1]) <= 0.01
                                        for a, b in zip(parsed(got), parsed(want))) and os.path.isfile(out_png),
          f"detect printed {got}, the CPU {want}")
    print(f"classify --device cuda: {' | '.join(run_cli(classify.main, ['-i', cell, '--device', 'cuda'])[0])} "
          f"{stamp}")
    t = timed_s(dev, lambda: run_cli(detect.main, ["-i", frame_png, "-c", "0.5", "--device", "cuda"]))
    print(f"detect -c 0.5 --device cuda: {len(got)} detections, labels equal to the CPU run's and confidences "
          f"within 0.01 %; annotated image written; {t * 1e3:.1f} ms with the model load and PNG decode {stamp}")
    demo = "demo_out/601_3.avi"
    lines, scored = run_cli(realtime.main, ["-s", demo, "--max-frames", str(REALTIME_FRAMES),
                                                   "-o", os.path.join(tmp, "rt.avi"), "--device", "cuda"])
    check(len(lines) == 2 and lines[1].startswith("[INFO] approx. FPS: ") and scored == REALTIME_FRAMES,
          f"realtime scored {scored} frames, printed {lines}")
    print(f"realtime -s {demo} --max-frames {REALTIME_FRAMES} --device cuda: {' | '.join(lines)} {stamp}")


def smallcnn_phase(dev, stamp: str, frame: np.ndarray) -> None:
    """Phase 5j: ClassifierNet (SmallCNN, 1000 classes) forward on a 224×224
    blob of a frame, on the card and on the CPU from the same seeded
    parameters: logits within 1e-5 of their largest magnitude (raw pixels
    minus the mean make logits in the hundreds), top-5 equal; timed on the
    card."""
    import torch

    from opticalflowclustering_tpu_torch.models import cnn

    blob = cnn.blob_from_image(torch.from_numpy(frame).to(dev), mean=(104.0, 117.0, 123.0))
    ref_blob = cnn.blob_from_image(torch.from_numpy(frame), mean=(104.0, 117.0, 123.0))
    net, ref = cnn.ClassifierNet(seed=0, device=dev), cnn.ClassifierNet(seed=0, device="cpu")
    net.set_input(blob)
    ref.set_input(ref_blob)
    got, want = net.forward(), ref.forward()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    blob_err = float((blob.cpu() - ref_blob).abs().max())
    check(got.shape == (1, 1000) and err <= 1e-5, f"SmallCNN logits card vs CPU: {got.shape}, rel {err}")
    check([i for i, _ in cnn.top_k(got)] == [i for i, _ in cnn.top_k(want)], "SmallCNN top-5 differs")
    ms = 1e3 * float(np.median([timed_s(dev, net.forward) for _ in range(5)]))
    print(f"SmallCNN 224x224 blob, 1000 classes (largest logit {float(np.abs(want).max()):.4g}): card vs CPU "
          f"logits max diff {err:.3g} of it (tolerance 1e-5), "
          f"blob diff {blob_err:.3g}, top-5 equal; forward {ms:.2f} ms {stamp}")


def trainbounce_phase(dev, stamp: str, series: np.ndarray, tmp: str) -> None:
    """Phase 5k: the trainbounce CLI, 300 steps on window-9 hue windows cut
    from the clip's hue series (a window of it as the bounce CSV, the rest
    as two no-bounce CSVs), on the card and on the CPU from the same seeded
    initialisation: final losses within rel 1e-2 (card and CPU reductions
    differ, and 300 AdamW steps towards a loss near 0 may grow a rounding),
    the same dataset line, the saved npz keys equal. The card's run is timed
    twice: the first pays what the process's first `torch.optim` step
    imports (torch._dynamo), the second is the CLI's steady cost."""
    from opticalflowclustering_tpu_torch.cli import trainbounce

    n = len(series)
    parts = {"bounce": series[n // 3 : n // 3 + 15], "nobounce1": series[: n // 3],
             "nobounce2": series[n // 3 + 15 :]}
    files = {}
    for name, values in parts.items():
        files[name] = os.path.join(tmp, f"{name}.csv")
        with open(files[name], "w") as f:
            f.writelines(f"{i}.png,{float(v)!r}\n" for i, v in enumerate(values))
    dynamo_first = "torch._dynamo" not in sys.modules
    out = {}
    for run, where in (("cold", "cuda"), ("cuda", "cuda"), ("cpu", "cpu")):
        argv = ["--bounce", files["bounce"], "--nobounce", files["nobounce1"], files["nobounce2"],
                "--steps", "300", "--out", os.path.join(tmp, f"bounce_{where}.npz"), "--device", where]
        t0 = time.perf_counter()
        lines, (_, loss) = run_cli(trainbounce.main, argv)
        sync(dev)
        out[run] = (lines, time.perf_counter() - t0, loss)
    (lc, tc, loss_c), (lr, _, loss_r), t_cold = out["cuda"], out["cpu"], out["cold"][1]
    with np.load(os.path.join(tmp, "bounce_cuda.npz")) as a, np.load(os.path.join(tmp, "bounce_cpu.npz")) as b:
        keys_equal = sorted(a.files) == sorted(b.files) and len(a.files) == 6
        worst = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
    rel = abs(loss_c - loss_r) / abs(loss_r)
    check(lc[0] == lr[0] and keys_equal, f"trainbounce: {lc} vs {lr}")
    check(rel <= 1e-2, f"trainbounce final loss card {loss_c} vs CPU {loss_r}")
    print(f"trainbounce --steps 300 --device cuda: {' | '.join(lc[:2])}; final loss card {loss_c!r}, CPU "
          f"{loss_r!r} (rel diff {rel:.3g}, tolerance 1e-2); npz keys equal, params max abs diff {worst:.3g}; "
          f"{tc:.2f} s, {t_cold:.2f} s the first time in this process (torch._dynamo "
          f"{'first imported then' if dynamo_first else 'already imported'}) {stamp}")


def fused_train_phase(dev, stamp: str, videos: np.ndarray) -> dict:
    """Phase 5l: make_fused_train_step with FarnebackParams(warp_mode='fast')
    and GridParams(4, 6) over videos [B, N, H, W, 3] u8, `steps` steps on a
    2×2 mesh of the card and on a 1×1 mesh, each from the same seeded
    classifier: losses and parameters within rel 1e-5 of each other, each
    flow kernel's launches the design count (`flow_runs` of one flow a block
    and step); each step timed. Returns the launches."""
    import torch

    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.models.bounce_classifier import adamw, init_classifier
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.parallel.train import make_fused_train_step

    b, n, h, w = videos.shape[:4]
    steps = 3
    grid, flow = GridParams(4, 6), FarnebackParams(warp_mode="fast")
    labels = (np.arange(b * n).reshape(b, n) % 4 == 0).astype(np.float32)
    runs = {}
    for name, shape in (("2x2", {"dp": 2, "sp": 2}), ("1x1", {"dp": 1, "sp": 1})):
        mesh = make_mesh(shape, [dev] * (shape["dp"] * shape["sp"]))
        warm = init_classifier(torch.Generator().manual_seed(1), grid.rows * grid.cols, device=dev)
        make_fused_train_step(mesh, warm, adamw(warm.parameters(), 1e-3), grid, flow)(videos, labels)
        model = init_classifier(torch.Generator().manual_seed(0), grid.rows * grid.cols, device=dev)
        step = make_fused_train_step(mesh, model, adamw(model.parameters(), 1e-3), grid, flow)
        kernels.reset_launches()
        losses, times = [], []
        for _ in range(steps):
            sync(dev)
            t0 = time.perf_counter()
            losses.append(float(step(videos, labels)))
            sync(dev)
            times.append(time.perf_counter() - t0)
        blocks = shape["dp"] * shape["sp"]
        launches = kernels.flow_launches()
        want = flow_runs(1, 1, h, w, flow, blocks * steps)
        check(launches == want, f"fused train {name}: expected launches {want}, got {launches}")
        runs[name] = (model, losses, times, launches, want)
    (m22, l22, t22, n22, w22), (m11, l11, t11, n11, w11) = runs["2x2"], runs["1x1"]
    check(all(np.isfinite(l22)), f"fused train losses {l22}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l22, l11))
    param_rel = max(float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(m22.state_dict().values(), m11.state_dict().values()))
    check(loss_rel <= 1e-5 and param_rel <= 1e-5,
          f"fused train 2x2 vs 1x1: loss rel {loss_rel}, params rel {param_rel}")
    print(f"fused train step {list(videos.shape)} grid 4x6 warp_mode=fast, {steps} steps: losses "
          f"{', '.join(f'{v:.6f}' for v in l22)}; 2x2 vs 1x1 loss rel diff {loss_rel:.3g}, params rel diff "
          f"{param_rel:.3g} (tolerance 1e-5); launches 2x2 {n22} (design: one flow a block and step, 4 blocks x "
          f"{steps} steps = {w22}), 1x1 {n11} (design {w11})")
    for name, ts in (("2x2", t22), ("1x1", t11)):
        print(f"time fused train step {name} mesh of {dev}: {float(np.median(ts)) * 1e3:.1f} ms/step (median of "
              f"{steps}, runs {', '.join(f'{v * 1e3:.1f}' for v in ts)} ms) {stamp}")
    return {"fused_train_2x2": n22, "fused_train_1x1": n11}


def model_phases(dev, stamp: str, flow_bgr: np.ndarray, series: np.ndarray, videos: np.ndarray) -> dict:
    """Phases 5f-5l, the clustering and model paths, each run with the
    kernel launch counts set to 0 just before it and read just after (only
    the fused train step launches kernels). Returns the launches by path."""
    import tempfile


    launches = {}

    def counted(name, fn):
        kernels.reset_launches()
        fn()
        sync(dev)
        launches[name] = kernels.flow_launches()

    check(have_cv2(), "the model CLIs read and write images with cv2, which is not importable")
    with tempfile.TemporaryDirectory(prefix="ofc-smoke-") as tmp:
        counted("kmeans", lambda: kmeans_phase(dev, stamp, flow_bgr))
        counted("quantize", lambda: quantize_phase(dev, stamp, videos[0, 0]))
        counted("colorkmeans", lambda: colorkmeans_phase(dev, stamp, flow_bgr, tmp))
        counted("serving", lambda: serving_phase(dev, stamp, flow_bgr, tmp))
        counted("smallcnn", lambda: smallcnn_phase(dev, stamp, videos[0, 0]))
        counted("trainbounce", lambda: trainbounce_phase(dev, stamp, series, tmp))
    launches.update(fused_train_phase(dev, stamp, videos))
    return launches


def main() -> int:
    import torch

    # Phase 1: device.
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    card = card_line()
    print(card)

    from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_bgr
    from opticalflowclustering_tpu_torch.flow.farneback import (
        FarnebackParams,
        farneback_flow,
        poly_expansion,
        pyramid_plan,
    )
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.kernels.build import SOURCES, build
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
    from opticalflowclustering_tpu_torch.pipeline.bounce import (
        PipelineConfig,
        classify_bounce,
        process_frames,
    )
    from opticalflowclustering_tpu_torch.runtime import resolve_device
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    dev = resolve_device("cuda")
    stamp = f"[{card}]"

    # Phase 2: build every kernel from the checkout's sources, in one build.
    t0 = time.perf_counter()
    build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(SOURCES)})")

    # Phase 3: each kernel against its plain version on the card.
    err = {"warp_m": 0.0, "box_solve": 0.0}
    gen = torch.Generator(device=dev).manual_seed(0)

    def smooth_flow(b, h, w, amp):
        low = torch.randn(b, 2, h // 16 + 2, w // 16 + 2, generator=gen, device=dev)
        f = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear") * amp
        return f[:, 0].contiguous(), f[:, 1].contiguous()

    def compare(name, got, want, rtol, atol, tag):
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        err[name] = max(err[name], e)
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=lambda m: f"{name} {tag}: {m}")
        return e

    def check_bitwise(name, got, want, tag):
        torch.cuda.synchronize()
        e = max((g - w).abs().max().item() for g, w in zip(got, want))
        err[name] = max(err[name], e)
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name} {tag}: not bitwise, max abs err {e}")

    def m_case(b, h, w):
        """Random R0, R1, a smooth flow and the M that warp_m makes of them."""
        r0 = torch.randn(b, 5, h, w, generator=gen, device=dev) * 10
        r1 = torch.randn(b, 5, h, w, generator=gen, device=dev) * 10
        fx, fy = smooth_flow(b, h, w, 3.0)
        return r0, r1, fx, fy, kw.warp_m(r0, r1, fx, fy)

    params = FarnebackParams()
    levels = [(16, h_k, w_k) for _, h_k, w_k, _ in reversed(pyramid_plan(H, W, params))]

    for b, h, w in [(2, 72, 300), (3, 40, 100), (16, H, W)]:
        r0 = torch.randn(b, 5, h, w, generator=gen, device=dev) * 10
        r1 = torch.randn(b, 5, h, w, generator=gen, device=dev) * 10
        flows = {
            "smooth": smooth_flow(b, h, w, 3.0),
            "large": tuple(
                (torch.rand(b, h, w, generator=gen, device=dev) * 300 - 150).contiguous()
                for _ in range(2)
            ),
        }
        for tag, (fx, fy) in flows.items():
            m = kw.warp_m(r0, r1, fx, fy)
            e = compare("warp_m", m, kw.warp_m_reference(r0, r1, fx, fy), 1e-4, 1e-3, f"{tag} {b}x{h}x{w}")
            q = kw.quantize_r1_fast16(r1)
            e16 = compare("warp_m", kw.warp_m(r0, q, fx, fy), kw.warp_m_reference(r0, q, fx, fy),
                          1e-4, 1e-3, f"fast16 {tag} {b}x{h}x{w}")
            for ws in (15, 17):
                check_bitwise("box_solve", kw.box_solve(m, ws), kw.box_solve_reference(m, ws),
                              f"ws{ws} {tag} [{b},5,{h},{w}]")
            print(f"check warp_m {tag} [{b},5,{h},{w}]: max_abs_err {e:.3g} (fast16 {e16:.3g}); "
                  f"box_solve of its M at winsize 15, 17 bitwise equal to the plain version")
        ri0 = torch.randint(-8, 8, (b, 5, h, w), generator=gen, device=dev).float()
        ri1 = torch.randint(-8, 8, (b, 5, h, w), generator=gen, device=dev).float()
        fi = [torch.randint(-150, 150, (b, h, w), generator=gen, device=dev).float() for _ in range(2)]
        mk = kw.warp_m(ri0, ri1, *fi)
        mr = kw.warp_m_reference(ri0, ri1, *fi)
        compare("warp_m", mk, mr, 1e-4, 1e-3, f"integer {b}x{h}x{w}")
        check(torch.equal(mk[..., 5:-5, 5:-5], mr[..., 5:-5, 5:-5]),
              f"warp_m integer-exact interior not bitwise [{b},5,{h},{w}]")
        print(f"check warp_m integer-exact [{b},5,{h},{w}]: interior bitwise, full equal={torch.equal(mk, mr)}")

    # box_solve bit for bit, at every winsize, on every level and small shape.
    for b, h, w in levels + list(BOX_SHAPES):
        m = m_case(b, h, w)[-1]
        for ws in BOX_WINSIZES:
            check_bitwise("box_solve", kw.box_solve(m, ws), kw.box_solve_reference(m, ws),
                          f"ws{ws} [{b},5,{h},{w}]")
        print(f"check box_solve winsize {BOX_WINSIZES[0]}..{BOX_WINSIZES[-1]} (odd) [{b},5,{h},{w}]: "
              f"bitwise equal to the plain version")
    del m

    # Phase 3b: the probe kernels and their scripts.
    probe_kernels = probe_phase(dev, stamp)

    # Phase 3c: the poly-expansion kernel, bit for bit and timed.
    crop = [(16, h_k, w_k) for _, h_k, w_k, _ in reversed(pyramid_plan(*CROP_HW, params))]
    poly_times = poly_phase(dev, stamp, levels, params, crop)

    # Phase 3e: the pyramid kernel, bit for bit and timed, at the levels of
    # bounce720-fast, bounce720-gauss and the crop.
    accurate = FarnebackParams(warp_mode="fast", **ACCURATE)
    pyramid_times = pyramid_phase(dev, stamp, [("bounce720-fast", 16, H, W, params),
                                               ("bounce720-gauss", 16, H, W, accurate),
                                               ("cropflow-fast", 16, *CROP_HW, params)])

    # Phase 3d: the Gaussian-solve kernel, bit for bit and timed, and the
    # pipeline at OpenCV's accurate settings.
    frames = synth_frames(N, H, W)
    gauss_levels = [(16, h_k, w_k) for _, h_k, w_k, _ in reversed(pyramid_plan(H, W, accurate))]
    gauss = gauss_phase(dev, stamp, gauss_levels, accurate, frames, GAUSS_SHAPES)

    # Phase 4: the slice, at 1280x720, through process_frames.
    launches = {}
    outs = {}
    for mode in ("fast", "fast16"):
        cfg = PipelineConfig(flow=FarnebackParams(warp_mode=mode))
        kernels.reset_launches()
        out = process_frames(frames, cfg, device="cuda")
        torch.cuda.synchronize()
        launches[mode] = kernels.flow_launches()
        print(f"slice {mode}: launches {launches[mode]}")
        runs = flow_runs(N - 1, cfg.chunk, H, W, cfg.flow)
        check(launches[mode] == runs and runs["warp_m"] == 36,
              f"{mode}: expected launches {runs} (36 of warp_m and box_solve each), got {launches[mode]}")
        n_pairs = N - 1
        check(out["hue_table"].shape == (n_pairs, 350), f"hue_table {out['hue_table'].shape}")
        check(out["rgb_hue_table"].shape == (n_pairs, 350), "rgb_hue_table shape")
        check(out["centroids"].shape == (n_pairs, 350, 4), "centroids shape")
        check(out["flow_bgr"].shape == (n_pairs, H, W, 3), "flow_bgr shape")
        check(np.isfinite(out["mean_magnitude"]).all() and np.isfinite(out["rgb_hue_table"]).all(),
              "non-finite tables")
        check(float(out["mean_magnitude"].max()) > 0.01, "no motion found")
        outs[mode] = out

    # The same pipeline on CPU tensors (plain versions) for the first 4 pairs.
    head = frames[:5]
    g = bgr2gray(torch.from_numpy(head))
    for mode in ("fast", "fast16"):
        p = FarnebackParams(warp_mode=mode)
        fg = farneback_flow(g[:-1].to(dev), g[1:].to(dev), p).cpu()
        fc = farneback_flow(g[:-1], g[1:], p)
        epe = float(torch.linalg.vector_norm(fg - fc, dim=-1).mean())
        check(epe <= 1e-3, f"{mode}: flow mean EPE card vs CPU {epe}")
        cpu = process_frames(head, PipelineConfig(flow=p), device="cpu")
        gpu = {k: v[:4] for k, v in outs[mode].items()}
        md = float(np.abs(cell_means(gpu["flow_bgr"]) - cell_means(cpu["flow_bgr"])).max())
        check(md <= 2.0, f"{mode}: render cell means differ by {md}")
        ex = check_hues(gpu["hue_table"], cpu["hue_table"], sat(cpu["centroids"]), f"{mode} OutCSV")
        mean_bgr = grid_mean_bgr(torch.from_numpy(cpu["flow_bgr"]), GridParams()).numpy()
        check_hues(gpu["rgb_hue_table"], cpu["rgb_hue_table"], sat(mean_bgr),
                   f"{mode} rgb_values", min_exact=0.94)
        print(f"e2e {mode} card vs CPU (4 pairs): flow mean EPE {epe:.3g} px, "
              f"render cell-mean diff {md:.3g}, hue exact share {ex:.4f}, "
              f"flow bitwise equal {torch.equal(fg, fc)}")

    # Pure-noise 720p frames: finite, and each kernel within tolerance of its
    # plain version on the level-0 expansion and the flow the pipeline found.
    nz = noise_frames(9, H, W)
    kernels.reset_launches()
    out_n = process_frames(nz, PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode="fast")), "cuda")
    check(np.isfinite(out_n["mean_magnitude"]).all(), "noise: non-finite mean magnitude")
    check(all(v for k, v in kernels.flow_launches().items() if k != "gauss_solve"),
          f"noise: a kernel was not launched: {kernels.flow_launches()}")
    gn = bgr2gray(torch.from_numpy(nz).to(dev)).float()
    flow_n = farneback_flow(gn[:-1], gn[1:], FarnebackParams(warp_mode="fast"))
    check(bool(torch.isfinite(flow_n).all()), "noise: non-finite flow")
    r0 = poly_expansion(gn[:-1], 5, 1.2, channel_first=True)
    r1 = poly_expansion(gn[1:], 5, 1.2, channel_first=True)
    fx, fy = flow_n[..., 0].contiguous(), flow_n[..., 1].contiguous()
    m = kw.warp_m(r0, r1, fx, fy)
    en = compare("warp_m", m, kw.warp_m_reference(r0, r1, fx, fy), 1e-4, 1e-3, "noise")
    check_bitwise("box_solve", kw.box_solve(m, 15), kw.box_solve_reference(m, 15), "noise")
    print(f"noise {W}x{H} x{nz.shape[0]}: finite; max |flow| {flow_n.abs().max().item():.3g} px; "
          f"warp_m err {en:.3g}, box_solve bitwise equal")

    # Phase 5: bounce match on the card's hue series.
    series = torch.from_numpy(outs["fast"]["hue_table"]).to(dev).float().mean(dim=1)
    sig = series[20:25].clone()
    check(float(sig.abs().sum()) > 0, "hue series window is all zero")
    sim, frame = classify_bounce(sig, series, device="cuda")
    check(sim >= 1 - 1e-6, f"bounce match similarity {sim}")
    check(bool(torch.equal(series[frame : frame + 5], sig)), f"bounce match frame {frame}")
    print(f"bounce match: similarity {sim:.7f} at frame {frame}")

    # Phases 5b-5e: the video-file paths at 1280x720, each run with the
    # launch counts set to 0 just before and read just after.
    if have_cv2():
        import cv2

        source = (f"cv2 {cv2.__version__} (demo_out/601_3.avi through the cv2 stream; the queue's clips "
                  "written as MJPG and decoded by io.video.read_video_bgr)")
    else:
        source = ("in-memory clips (scripts/clips.synth_frames) through the same prefetch thread and in "
                  "place of the queue's decoder; cv2 is not importable")
    print(f"decode source: {source}")
    fast = PipelineConfig(flow=FarnebackParams(warp_mode="fast"))
    path_launches = {"process_frames": launches["fast"]}
    path_launches["stream"] = stream_phase(dev, stamp, frames, outs["fast"], fast)
    step = QUEUE_CLIP - 1
    clips = [frames[i * step : i * step + QUEUE_CLIP] for i in range(3)]
    path_launches.update(queue_phase(dev, stamp, clips, fast))
    path_launches.update(temporal_phase(dev, np.stack([frames[:16], frames[16:32]]), fast))
    findcosine_phase(series.cpu().numpy(), 20, 5)

    # Phase 5m: the native MJPEG decoder and its stream at 1280x720, on
    # baseline, progressive and arithmetic-coded (SOF9, SOF10) frames, each
    # stream run with the launch counts set to 0 just before and read just
    # after.
    path_launches.update(native_decode_phase(dev, stamp, frames, fast))

    # Phases 5n-5q: EPE against cv2 and the grid CLIs at 1280x720, each run
    # with the launch counts set to 0 just before and read just after.
    path_launches.update(surface_phases(dev, stamp, frames, series.cpu().numpy(),
                                        outs["fast"]["rgb_hue_table"].mean(axis=1)))

    # Phases 5r-5s: kmeangrids' overlay path and the ops/ modules at
    # 1280x720, each run with the launch counts set to 0 just before and
    # read just after.
    path_launches.update(overlay_ops_phases(dev, stamp, frames))

    # Phases 5t-5v: the row-sharded flow, the dryrun entry and the extras at
    # 1280x720, each run with the launch counts set to 0 just before and
    # read just after.
    path_launches.update(spatial_dryrun_extras_phases(dev, stamp, frames))

    # Phase 5w: the 'select' warp (plain PyTorch, no warp_m or box_solve) at 1280x720
    # and on real footage, each run with the launch counts set to 0 just
    # before and read just after.
    path_launches.update(select_phase(dev, stamp, frames))

    # Phases 5f-5l: the clustering and model paths at 1280x720, each run
    # with the launch counts set to 0 just before and read just after.
    path_launches.update(model_phases(
        dev, stamp, outs["fast"]["flow_bgr"], series.cpu().numpy(), np.stack([frames[:16], frames[16:32]])))

    # Phase 6: times on the card.
    def pipeline_fps(mode):
        cfg = PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode=mode))
        process_frames(frames, cfg, device="cuda")  # warm-up
        times = []
        for _ in range(REPEATS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            process_frames(frames, cfg, device="cuda")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return (N - 1) / float(np.median(times)), times

    for mode in ("fast", "fast16", "exact"):
        fps, times = pipeline_fps(mode)
        label = "kernels" if mode != "exact" else "plain PyTorch warp, the poly kernel alone"
        print(f"time process_frames {N}x{H}x{W} warp_mode={mode} ({label}): "
              f"{fps:.2f} pairs/s (median of {REPEATS}, runs {', '.join(f'{t:.3f}' for t in times)} s) {stamp}")

    # Each pipeline kernel at each pyramid level, beside its bound; at the
    # finest level also its plain version, in turns.
    kernel_times, per_level = {}, {"warp_m": [], "box_solve": []}
    for b, h, w in levels:
        r0, r1, fx, fy, m = m_case(b, h, w)
        pairs = {
            "warp_m": (lambda: kw.warp_m(r0, r1, fx, fy), lambda: kw.warp_m_reference(r0, r1, fx, fy)),
            "box_solve": (lambda: kw.box_solve(m, params.winsize),
                          lambda: kw.box_solve_reference(m, params.winsize)),
        }
        for name, (kern, plain) in pairs.items():
            bound, by = bound_ms(kw.kernel_bytes(name, b, h, w), kw.kernel_ops(name, b, h, w, params.winsize))
            if (h, w) == (H, W):
                p1, k1, k2, p2 = loop_ms(plain, 10), loop_ms(kern, 50), loop_ms(kern, 50), loop_ms(plain, 10)
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                kernel_times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
                order = f", plain {plain_ms:.4f} ms (order plain, kernel, kernel, plain)"
            else:
                ms, order = loop_ms(kern, 50), ""
            per_level[name].append((ms, bound))
            print(f"time {name} [{b},5,{h},{w}]: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"{bound / ms:.1%} of the bound{order} (CUDA events) {stamp}")
        if (h, w) == (H, W):
            for ws in BOX_WINSIZES:
                ms = loop_ms(lambda: kw.box_solve(m, ws), 20)
                bound, by = bound_ms(kw.kernel_bytes("box_solve", b, h, w), kw.kernel_ops("box_solve", b, h, w, ws))
                print(f"time box_solve [{b},5,{h},{w}] winsize {ws}: kernel {ms:.4f} ms, bound {bound:.4f} ms "
                      f"({by}), {bound / ms:.1%} of the bound (CUDA events) {stamp}")
    del r0, r1, fx, fy, m
    for name, rows in per_level.items():
        n = len(rows) * params.iterations
        ms = params.iterations * sum(t for t, _ in rows)
        bound = params.iterations * sum(bd for _, bd in rows)
        print(f"time {name} per 16-pair chunk ({len(rows)} levels x {params.iterations} iterations = "
              f"{n} launches): {ms:.4f} ms, bound {bound:.4f} ms, {bound / ms:.1%} of the bound {stamp}")

    # Phase 7: results.
    src = "opticalflowclustering_tpu_torch/kernels/csrc/"
    results = [
        {"name": "warp_m", "route": "cuda", "source": src + "warp_m.cu",
         "replaces": "opticalflowclustering_tpu/kernels/warp.py:177",
         "launches": launches["fast"]["warp_m"], "max_abs_err": err["warp_m"],
         **kernel_times["warp_m"], "library_ms": None,
         "launches_by_path": {k: v["warp_m"] for k, v in path_launches.items()}},
        {"name": "box_solve", "route": "cuda", "source": src + "box_solve.cu",
         "replaces": "opticalflowclustering_tpu/kernels/warp.py:338",
         "launches": launches["fast"]["box_solve"], "max_abs_err": err["box_solve"],
         **kernel_times["box_solve"], "library_ms": None,
         "launches_by_path": {k: v["box_solve"] for k, v in path_launches.items()}},
        {"name": "gauss_solve", "route": "cuda", "source": src + "gauss_solve.cu",
         "replaces": None, "launches": gauss["launches"]["gauss_solve"],
         **{k: v for k, v in gauss.items() if k != "launches"}, "library_ms": None,
         "launches_by_path": {"accurate_settings": gauss["launches"]["gauss_solve"],
                              **{k: v["gauss_solve"] for k, v in path_launches.items()}}},
        {"name": "poly_expansion", "route": "cuda", "source": src + "poly_expansion.cu",
         "replaces": None, "launches": launches["fast"]["poly_expansion"], **poly_times, "library_ms": None,
         "launches_by_path": {k: v["poly_expansion"] for k, v in path_launches.items()}},
        {"name": "pyramid", "route": "cuda", "source": src + "pyramid.cu",
         "replaces": None, "launches": launches["fast"]["pyramid"], **pyramid_times["bounce720-fast"],
         "library_ms": None, "by_configuration": pyramid_times,
         "launches_by_path": {"accurate_settings": gauss["launches"]["pyramid"],
                              **{k: v["pyramid"] for k, v in path_launches.items()}}},
    ] + probe_kernels
    print(card)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
