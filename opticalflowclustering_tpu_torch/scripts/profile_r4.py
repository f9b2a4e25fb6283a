"""Warp-roofline experiments on the card (counterpart of
`scripts/profile_r4.py`). Each decides whether a rewrite of the warp+M
kernel could pay before it is written:

  A. packed takes — one gather of an f32 whose bits hold two 16-bit values,
     then the unpack (bitcast → mask and logical shift → 2 converts),
     against two f32 gathers; the `loop_probe` kernel at the TPU script's
     trip counts, ns per iteration by the slope between them.
  B. merging warp+M into box_solve — the HBM stream bandwidth, measured as
     the slope of an in-place `add_` over a [32, 720, 1280] float32 buffer
     (118 MB, 2 × nbytes moved per step) between 20 and 120 steps, and the
     bound it puts on what deleting M's round trip through HBM (5 planes of
     720×1280 float32 written, then read) can save.
  D. fast against fast16 end to end — `chunk_step` over the 49-frame smooth
     and noise clips at 1280×720, chunk 8, with the chunks uploaded once:
     the rate of the device work alone, without the host-to-device copy, so
     it is not chip_smoke's `process_frames` rate.
  C. the accounting. The TPU script estimated a gather share from D's
     fast → fast16 delta (Δ/0.4: fast16 removed 40% of its takes and window
     DMAs). In the port fast16 rounds R1 through bf16 and then runs the
     same f32 warp_m kernel, so it removes no gather bytes and Δ/0.4 does
     not measure a gather share on this card; it is printed for comparison.
     The accounting that does measure one: A's per-take cost × warp_m's 20
     corner loads per pixel (4 corners × 5 channels of R1), against
     warp_m's measured time.

    python -m opticalflowclustering_tpu_torch.scripts.profile_r4 --device cuda
"""

from __future__ import annotations

import argparse

import torch

from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
from opticalflowclustering_tpu_torch.kernels import probes
from opticalflowclustering_tpu_torch.kernels import warp as kw
from opticalflowclustering_tpu_torch.pipeline.bounce import (
    PipelineConfig,
    _stack_chunks,
    chunk_step,
)
from opticalflowclustering_tpu_torch.runtime import resolve_device
from opticalflowclustering_tpu_torch.scripts import clips
from opticalflowclustering_tpu_torch.scripts import gather_cost_probe as gcp
from opticalflowclustering_tpu_torch.utils import profiling

N_LO, N_HI = 100_000, 600_000  # A's trip counts (the TPU script's)
BW_SHAPE = (32, 720, 1280)  # B's streamed buffer, float32
K_LO, K_HI = 20, 120  # B's step counts
H, W = 720, 1280  # frame size of B's M planes, C and D
FRAMES, CHUNK = 49, 8  # D's clips
REPEATS = 3  # D's timed runs per mode and clip
WARP_BATCH = 8  # C times warp_m on one chunk's pairs
CORNER_LOADS = 20  # warp_m reads 4 corners x 5 channels of R1 per pixel


def experiment_a_packed_takes(dev, stamp: str) -> tuple[float, float]:
    """ns per iteration of two f32 takes and of one packed take + unpack."""
    x, idx = gcp.tile(dev)
    t2 = gcp.per_iter_ns("two_takes", x, idx, N_LO, N_HI)
    t1 = gcp.per_iter_ns("packed_take_unpack", x, idx, N_LO, N_HI)
    print(f"A. two f32 takes: {t2:.3f} ns/iter; packed take+unpack: {t1:.3f} ns/iter "
          f"-> two takes cost {t2 / t1:.2f}x the packed take "
          f"({'WIN' if t1 < 0.85 * t2 else 'no win'}; 16-bit packing makes it "
          f"an approximate mode only) (CUDA events, slope {N_LO}->{N_HI}) {stamp}")
    return t2, t1


def experiment_b_merge_bound(dev, stamp: str) -> float:
    """Seconds per image-iteration that deleting M's HBM round trip can save
    at most, at the measured stream bandwidth."""
    nbytes = 5 * H * W * 4  # M planes, float32
    buf = torch.zeros(BW_SHAPE, dtype=torch.float32, device=dev)

    def steps(k):
        def run():
            for _ in range(k):
                buf.add_(1.0)

        return run

    per_step_ms = profiling.slope_ms(steps, K_LO, K_HI, repeats=5)
    bw = 2 * buf.nbytes / (per_step_ms * 1e-3)  # read + write per step
    saving = 2 * nbytes / bw  # write then read, deleted
    print(f"B. HBM stream bandwidth {bw / 1e9:.1f} GB/s (in-place add on "
          f"{list(BW_SHAPE)} float32, {buf.nbytes / 1e6:.0f} MB, slope {K_LO}->{K_HI} "
          f"steps); deleting the M round trip saves <= {saving * 1e6:.2f} us per "
          f"image-iteration at {W}x{H} {stamp}")
    return saving


def experiment_d_fast16_end_to_end(dev, stamp: str) -> dict[tuple[str, str], float]:
    """Seconds per pair of chunk_step in 'fast' and 'fast16' on the smooth and
    the noise clip, chunks already on the device (mean of REPEATS warm runs)."""
    out = {}
    for kind in ("smooth", "noise"):
        make = clips.synth_frames if kind == "smooth" else clips.noise_frames
        frames = make(FRAMES, H, W)
        for mode in ("fast", "fast16"):
            cfg = PipelineConfig(chunk=CHUNK, emit_flow_bgr=False,
                                 flow=FarnebackParams(warp_mode=mode))
            chunks, n_pairs = _stack_chunks(frames, cfg.chunk)
            on_dev = torch.from_numpy(chunks).to(dev)

            def run():
                return [chunk_step(c, cfg, dev) for c in on_dev]

            run()  # warm-up
            timer = profiling.StageTimer()
            for _ in range(REPEATS):
                with timer.stage(kind, sync=on_dev):
                    run()
            per_pair = timer.totals[kind] / timer.counts[kind] / n_pairs
            out[(mode, kind)] = per_pair
            print(f"D. {mode}/{kind}: {1 / per_pair:.1f} pairs/s ({per_pair * 1e3:.3f} "
                  f"ms/pair) at {W}x{H}, chunk {CHUNK}, mean of {REPEATS}; chunks "
                  f"already on the card, so no host-to-device copy: not "
                  f"chip_smoke's process_frames rate {stamp}")
    return out


def warp_m_ms(dev) -> float:
    """ms per warp_m launch on one chunk's pairs, [WARP_BATCH, 5, H, W]."""
    gen = torch.Generator(device=dev).manual_seed(0)
    r0 = torch.randn(WARP_BATCH, 5, H, W, generator=gen, device=dev) * 10
    r1 = torch.randn(WARP_BATCH, 5, H, W, generator=gen, device=dev) * 10
    low = torch.randn(WARP_BATCH, 2, H // 16 + 2, W // 16 + 2, generator=gen, device=dev)
    f = torch.nn.functional.interpolate(low, size=(H, W), mode="bilinear") * 3.0
    fx, fy = f[:, 0].contiguous(), f[:, 1].contiguous()
    return profiling.event_ms(lambda: kw.warp_m(r0, r1, fx, fy))


def experiment_c_accounting(
    saving_b: float,
    d_times: dict[tuple[str, str], float],
    take_ns: float,
    warp_ms: float,
    stamp: str = "",
) -> dict:
    """The TPU script's Δ/0.4 arithmetic on D's times (not a gather share
    here, see the module docstring) and B's merge bound as a share of a
    pair; then the measured gather accounting from A's per-take cost
    `take_ns` and warp_m's time `warp_ms`."""
    out = {}
    for kind in ("smooth", "noise"):
        per_pair = d_times[("fast", kind)]
        delta = per_pair - d_times[("fast16", kind)]
        share = delta / 0.4 / per_pair
        merge = saving_b * 3 / per_pair  # 3 top-level image-iterations
        out[kind] = {"per_pair_ms": per_pair * 1e3, "delta_ms": delta * 1e3,
                     "share_pct": share * 100, "merge_pct": merge * 100}
        print(f"C. {kind}: {per_pair * 1e3:.2f} ms/pair; fast16 delta {delta * 1e3:.2f} "
              f"ms/pair -> delta/0.4 = {share * 100:.0f}% of the pair (the TPU "
              f"estimate; fast16 runs the same f32 warp_m here, so this is no "
              f"gather share); M-merge bound from B covers {merge * 100:.1f}%")
    pixels = WARP_BATCH * H * W
    gather_ms = take_ns * 1e-6 / (probes.ROWS * probes.LANES) * CORNER_LOADS * pixels
    out["gather_ms"] = gather_ms
    out["gather_share_pct"] = 100 * gather_ms / warp_ms
    print(f"C. measured accounting: A's per-take cost {take_ns:.3f} ns per "
          f"[80,128] take x {CORNER_LOADS} corner loads per pixel x {pixels} "
          f"pixels = {gather_ms:.4f} ms, against warp_m's {warp_ms:.4f} ms at "
          f"[{WARP_BATCH},5,{H},{W}] -> {out['gather_share_pct']:.1f}% (a shared-memory "
          f"gather of the fresh row on one wave of 80 blocks, its random idx's bank "
          f"conflicts included, spread over 10240 lanes: "
          f"it overstates what warp_m's cached loads cost at full occupancy) {stamp}")
    return out


def run_all(dev, stamp: str) -> dict:
    t2, t1 = experiment_a_packed_takes(dev, stamp)
    saving = experiment_b_merge_bound(dev, stamp)
    d_times = experiment_d_fast16_end_to_end(dev, stamp)
    warp_ms = warp_m_ms(dev)
    c = experiment_c_accounting(saving, d_times, t2 / 2, warp_ms, stamp)
    return {"two_takes_ns": t2, "packed_ns": t1, "merge_saving_s": saving,
            "d_times": d_times, "warp_m_ms": warp_ms, "c": c}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the CUDA device to time (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        ap.error("the experiments time the card: --device must name a CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    torch.cuda.set_device(index)
    run_all(dev, f"[{profiling.card_line(index)}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
