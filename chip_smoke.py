#!/usr/bin/env python3
"""Smoke test of the PyTorch port (opticalflowclustering_tpu_torch) on one
CUDA card: builds the port's kernels (warp+M, box-solve and the gather-cost
probes) from the sources in the checkout, holds each against its plain
PyTorch version on the card (box-solve bit for bit at every odd winsize up to
17, on the 720p pyramid's level shapes and on small frames), runs the probe
scripts (gather_cost_probe, profile_r4) at their full sizes, drives the
bounce-feature pipeline (process_frames) at 1280x720 with both kernel warp
modes, checks it against the same pipeline on CPU tensors, matches a bounce
signature, and times the pipeline and each kernel, the pipeline kernels at
each pyramid level beside their bounds (the least time the card could take:
bytes over the HBM rate or operations over the float32 rate).

    python3 chip_smoke.py

Exits non-zero, printing no result, when there is no CUDA device or any
phase fails. On success the line before the last is a JSON object with one
entry per kernel, and the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports torch and numpy only (no JAX, no cv2).
"""

from __future__ import annotations

import functools
import json
import sys
import time

import numpy as np

from opticalflowclustering_tpu_torch.scripts.clips import noise_frames, synth_frames
from opticalflowclustering_tpu_torch.utils.profiling import card_line

H, W, N = 720, 1280, 49
REPEATS = 3
PROBE_CHECK_N = (1, 7, 256)  # probe checks: the plain loops run in Python
PLAIN_SLOPE_N = (64, 256)  # trip counts of the plain loops' per-iteration slope
# box_solve's bitwise check: every odd winsize the kernel takes, on the
# pyramid's level shapes and on these, whose windows are wider than the
# frame or whose widths are no multiple of 4.
BOX_WINSIZES = tuple(range(1, 18, 2))
BOX_SHAPES = ((2, 72, 300), (3, 40, 100), (1, 5, 7), (1, 3, 40))


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
    plain version on the card (bitwise, at small trip counts), times the
    plain loops per iteration, then runs the probe scripts at their full
    sizes with every launch count set to 0 just before, and checks that each
    probe kernel (and warp_m, box_solve through profile_r4's D) launched.
    Returns the kernels' entries of the results line."""
    import torch

    from opticalflowclustering_tpu_torch.kernels import probes
    from opticalflowclustering_tpu_torch.kernels import warp as kw
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
    take_ms = profiling.event_ms(lambda: probes.loop_probe("take", x, idx, n_ms))
    take_plain_ms = profiling.event_ms(lambda: probes.loop_probe_reference("take", x, idx, n_ms), 3)
    dyn_plain_ms = profiling.event_ms(lambda: probes.dynslice_reference(xb, one))
    take_bound, take_by = profiling.bound_ms(*probes.loop_probe_cost("take", x.shape[0], n_ms))
    dyn_bound, dyn_by = profiling.bound_ms(*probes.dynslice_cost())

    # The probe path: both scripts at their full sizes.
    probes.reset_launches()
    kw.reset_launches()
    g = gcp.run_all(dev, stamp)
    r = pr4.run_all(dev, stamp)
    launches, warp_launches = dict(probes.LAUNCHES), dict(kw.LAUNCHES)
    print(f"probe path: launches {launches}, {warp_launches}")
    check(all(v > 0 for v in launches.values()), f"a probe kernel was not launched: {launches}")
    check(all(v > 0 for v in warp_launches.values()), f"profile_r4 D launched no warp kernel: {warp_launches}")

    kern_ns = dict(g["f32"], take_bf16=g["take_bf16"], two_takes=r["two_takes_ns"],
                   packed_take_unpack=r["packed_ns"])
    gcp_src, r4_src = "scripts/gather_cost_probe.py", "scripts/profile_r4.py"
    replaces = {"mul": f"{gcp_src}:34", "where": f"{gcp_src}:34", "take": f"{gcp_src}:34",
                "take_bf16": f"{gcp_src}:94", "two_takes": f"{r4_src}:72",
                "packed_take_unpack": f"{r4_src}:72"}
    bodies = {}
    for body in probes.BODIES:
        # One more iteration moves no byte: its bound is its operations'.
        bound_ns = 1e6 * profiling.bound_ms(0, probes.loop_probe_cost(body, x.shape[0], 1)[1])[0]
        bodies[body] = {"replaces": replaces[body], "ns_per_iter": kern_ns[body],
                        "plain_ns_per_iter": plain_ns[body], "bound_ns_per_iter": bound_ns}
        print(f"time loop_probe {body} [80,128]: kernel {kern_ns[body]:.3f} ns/iter, plain "
              f"{plain_ns[body]:.1f} ns/iter, bound {bound_ns:.3f} ns/iter ({bound_ns / kern_ns[body]:.1%}; "
              f"one dependent chain per thread on one wave) (CUDA events, slopes) {stamp}")
    print(f"time loop_probe take n={n_ms}: kernel {take_ms:.4f} ms, plain {take_plain_ms:.4f} ms, "
          f"bound {take_bound:.6f} ms ({take_by}); dynslice: kernel {g['dynslice_ms']:.4f} ms, "
          f"plain {dyn_plain_ms:.4f} ms, bound {dyn_bound:.6f} ms ({dyn_by}) (CUDA events; a dependent "
          f"chain and one launch, so far from any bound by design) {stamp}")
    src = "opticalflowclustering_tpu_torch/kernels/csrc/probes.cu"
    return [
        {"name": "loop_probe", "route": "cuda", "source": src,
         "replaces": f"{gcp_src}:34, {gcp_src}:94, {r4_src}:72",
         "launches": launches["loop_probe"], "max_abs_err": err["loop_probe"],
         "ms": take_ms, "plain_ms": take_plain_ms, "bound_ms": take_bound, "bound_by": take_by,
         "library_ms": None, "ms_of": f"take, n={n_ms}", "bodies": bodies},
        {"name": "dynslice", "route": "cuda", "source": src, "replaces": f"{gcp_src}:133",
         "launches": launches["dynslice"], "max_abs_err": err["dynslice"],
         "ms": g["dynslice_ms"], "plain_ms": dyn_plain_ms, "bound_ms": dyn_bound, "bound_by": dyn_by,
         "library_ms": None},
    ]


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

    # Phase 4: the slice, at 1280x720, through process_frames.
    frames = synth_frames(N, H, W)
    launches = {}
    outs = {}
    for mode in ("fast", "fast16"):
        cfg = PipelineConfig(flow=FarnebackParams(warp_mode=mode))
        kw.reset_launches()
        out = process_frames(frames, cfg, device="cuda")
        torch.cuda.synchronize()
        launches[mode] = dict(kw.LAUNCHES)
        print(f"slice {mode}: launches {launches[mode]}")
        check(launches[mode] == {"warp_m": 36, "box_solve": 36},
              f"{mode}: expected 36 launches of each kernel, got {launches[mode]}")
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
    kw.reset_launches()
    out_n = process_frames(nz, PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode="fast")), "cuda")
    check(np.isfinite(out_n["mean_magnitude"]).all(), "noise: non-finite mean magnitude")
    check(kw.LAUNCHES["warp_m"] > 0 and kw.LAUNCHES["box_solve"] > 0, "noise: kernels not launched")
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
        label = "kernels" if mode != "exact" else "plain PyTorch warp, no kernels"
        print(f"time process_frames {N}x{H}x{W} warp_mode={mode} ({label}): "
              f"{fps:.2f} pairs/s (median of {REPEATS}, runs {', '.join(f'{t:.3f}' for t in times)} s) {stamp}")

    def event_ms(fn, iters):
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
                p1, k1, k2, p2 = event_ms(plain, 10), event_ms(kern, 50), event_ms(kern, 50), event_ms(plain, 10)
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                kernel_times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by}
                order = f", plain {plain_ms:.4f} ms (order plain, kernel, kernel, plain)"
            else:
                ms, order = event_ms(kern, 50), ""
            per_level[name].append((ms, bound))
            print(f"time {name} [{b},5,{h},{w}]: kernel {ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                  f"{bound / ms:.1%} of the bound{order} (CUDA events) {stamp}")
        if (h, w) == (H, W):
            for ws in BOX_WINSIZES:
                ms = event_ms(lambda: kw.box_solve(m, ws), 20)
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
    kernels = [
        {"name": "warp_m", "route": "cuda", "source": src + "warp_m.cu",
         "replaces": "opticalflowclustering_tpu/kernels/warp.py:177",
         "launches": launches["fast"]["warp_m"], "max_abs_err": err["warp_m"],
         **kernel_times["warp_m"], "library_ms": None},
        {"name": "box_solve", "route": "cuda", "source": src + "box_solve.cu",
         "replaces": "opticalflowclustering_tpu/kernels/warp.py:338",
         "launches": launches["fast"]["box_solve"], "max_abs_err": err["box_solve"],
         **kernel_times["box_solve"], "library_ms": None},
    ] + probe_kernels
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
