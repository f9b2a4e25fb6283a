"""The yardstick, frozen here so that no change to the program moves it.

Peaks: one NVIDIA H100 SXM as NVIDIA's data sheet gives it, at its 700 W
power limit: HBM3 at 3.35 TB/s, and 67 TFLOP/s in float32 outside the
tensor cores, which counts a multiply-add as two, so 33.5 T adds or
multiplies a second.

Kernel counts: the bytes each pipeline kernel must move, every input read
once and every output written once in float32, and the float32 operations
it must do, per pixel of a [B, H, W] launch. warp_m reads R0 and R1 (5
planes each) and the flow (2) and writes M (5): 68 B; 101 operations (8 for
the sample coordinates and weights, 55 for the bilinear sample of 5 planes,
18 for R2..R6, 6 for the taper, 14 for M). box_solve reads M (5) and
writes the flow (2): 28 B; 2r adds per pass and channel, 5 scalings and the
13-operation solve, 20r + 18 with r = winsize // 2.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12

BYTES_PER_PIXEL = {"warp_m": 68, "box_solve": 28}


def ops_per_pixel(kernel: str, winsize: int) -> int:
    return {"warp_m": 101, "box_solve": 20 * (winsize // 2) + 18}[kernel]


def kernel_bytes(kernel: str, b: int, h: int, w: int) -> int:
    return BYTES_PER_PIXEL[kernel] * b * h * w


def kernel_ops(kernel: str, b: int, h: int, w: int, winsize: int) -> int:
    return ops_per_pixel(kernel, winsize) * b * h * w


def bound_s(nbytes: float, ops: float) -> float:
    """The least time an H100 could take: the larger of the bytes over HBM
    bandwidth and the operations over the float32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def roofline_pct(view, kernel: str) -> float | None:
    """The bound of the work the configuration asks of `kernel` for the
    traced window's pairs ÷ the device time of its traced launches (named
    `<kernel>_kernel`), in %; None where there is no launch or no pair.

    The work is counted from the configuration, not from the launches: each
    pair passes every pyramid level `iterations` times, one [1, h, w] pass a
    time, so the share does not depend on how the kernel lays out its grid
    or batches its pairs, and work beyond that (padding, halos) lowers it."""
    from ofc_bench.reference.bounce import pyramid_plan

    launches = view.kernels(f"{kernel}_kernel")
    if not launches or not view.pairs:
        return None
    cfg, fb = view.config, view.config["farneback"]
    per_pair = sum(bound_s(kernel_bytes(kernel, 1, h, w), kernel_ops(kernel, 1, h, w, fb["winsize"]))
                   for _, h, w, _ in pyramid_plan(cfg["height"], cfg["width"], fb["pyr_scale"], fb["levels"]))
    bound = view.pairs * fb["iterations"] * per_pair
    return 100.0 * bound / (sum(e.dur for e in launches) / 1e6)
