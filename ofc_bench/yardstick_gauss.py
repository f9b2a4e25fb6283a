"""The Gaussian-solve kernel's yardstick, frozen here so that no change to
the program moves it; the peaks are `yardstick.py`'s.

gauss_solve reads M (5 planes) and writes the flow (2): 28 bytes a pixel in
float32. Per pass and channel it does one product at the centre and, per
tap pair, an add, a product and an accumulation; then the 13-operation
solve: 30M + 23 float32 operations a pixel, M = winsize // 2.
"""

from __future__ import annotations

from ofc_bench.yardstick import bound_s

BYTES_PER_PIXEL = 28


def ops_per_pixel(winsize: int) -> int:
    return 30 * (winsize // 2) + 23


def roofline_pct(view) -> float | None:
    """The bound of the Gaussian solves the configuration asks for the
    traced window's pairs ÷ the device time of the traced launches named
    `gauss_solve_kernel`, in %; None where there is no launch or no pair.
    Counted from the configuration as `yardstick.roofline_pct` counts: each
    pair passes every pyramid level `iterations` times, one [1, h, w] pass
    a time."""
    from ofc_bench.reference.bounce import pyramid_plan

    launches = view.kernels("gauss_solve_kernel")
    if not launches or not view.pairs:
        return None
    cfg, fb = view.config, view.config["farneback"]
    per_pair = sum(bound_s(BYTES_PER_PIXEL * h * w, ops_per_pixel(fb["winsize"]) * h * w)
                   for _, h, w, _ in pyramid_plan(cfg["height"], cfg["width"], fb["pyr_scale"], fb["levels"]))
    bound = view.pairs * fb["iterations"] * per_pair
    return 100.0 * bound / (sum(e.dur for e in launches) / 1e6)
