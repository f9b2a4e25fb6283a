"""Microbenchmark: what does one per-element gather cost on the card, against
a select and a multiply of the same shape? (counterpart of
`scripts/gather_cost_probe.py`)

Each probe runs the `loop_probe` kernel (`kernels/csrc/probes.cu`) on one
[80, 128] tile at two trip counts and takes the slope between them, timed
with CUDA events: (t(N_HI) − t(N_LO)) / (N_HI − N_LO) cancels the launch.
It prints ns per iteration on [80, 128] with the card's name and power
limit. On the card one iteration of `take` is a shared-memory store, a
barrier and a shared-memory gather in a dependent chain per thread, on one
wave of 80 blocks: the probe prices that pattern's latency, which is a
different thing from the TPU's intra-vreg lane gather.

`probe_bf16` asks whether a bf16 gather costs less than the f32 one (the
question behind a warp_m that loads R1 as bf16); `probe_bf16_dynslice`
checks and times the dynamic 8-row window of a bf16 tile whose offset is
read on the device.

    python -m opticalflowclustering_tpu_torch.scripts.gather_cost_probe --device cuda
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from opticalflowclustering_tpu_torch.kernels import probes
from opticalflowclustering_tpu_torch.runtime import resolve_device
from opticalflowclustering_tpu_torch.utils import profiling

ROWS, LANES = probes.ROWS, probes.LANES
N_LO, N_HI = 2000, 34000
OPS = ("mul", "where", "take")


def tile(dev, dtype=torch.float32, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The probes' inputs, as the TPU script makes them: x ~ N(0, 1)
    [80, 128] in `dtype` and idx uniform in [0, 128) int32, from `seed`."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ROWS, LANES)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, LANES, (ROWS, LANES)).astype(np.int32))
    return x.to(dev, dtype), idx.to(dev)


def per_iter_ns(body: str, x, idx, lo: int, hi: int) -> float:
    """ns per iteration of `loop_probe(body)` by the slope between lo and hi
    trip counts; raises if the time does not grow with n."""
    return 1e6 * profiling.slope_ms(
        lambda n: functools.partial(probes.loop_probe, body, x, idx, n), lo, hi
    )


def probe_f32(dev, stamp: str) -> dict[str, float]:
    """ns per iteration of mul, where and take on an f32 [80, 128] tile."""
    x, idx = tile(dev)
    out = {}
    for op in OPS:
        out[op] = per_iter_ns(op, x, idx, N_LO, N_HI)
        print(f"{op}: {out[op]:.3f} ns per iteration on [80,128] "
              f"(CUDA events, slope {N_LO}->{N_HI}) {stamp}")
    return out


def probe_bf16(dev, stamp: str, take_f32_ns: float) -> float:
    """ns per iteration of the bf16 take on a bf16 [80, 128] tile, printed
    beside the f32 take's `take_f32_ns`."""
    x, idx = tile(dev, torch.bfloat16)
    ns = per_iter_ns("take_bf16", x, idx, N_LO, N_HI)
    print(f"take-bf16: {ns:.3f} ns per iteration on [80,128] "
          f"(CUDA events, slope {N_LO}->{N_HI}); {ns / take_f32_ns:.3f}x the f32 "
          f"take {stamp}")
    return ns


def probe_bf16_dynslice(dev, stamp: str) -> float:
    """Checks the dynslice kernel's window for off = 1 (rows 8..31) and
    returns its time per launch in ms; raises if the window is wrong."""
    x, _ = tile(dev, torch.bfloat16)
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    if not torch.equal(probes.dynslice(x, off), x[8:32].float()):
        raise RuntimeError("dynslice: the window for off = 1 is not x[8:32]")
    ms = profiling.event_ms(lambda: probes.dynslice(x, off))
    print(f"bf16 8-row dynamic row window (off read on the device): correct, "
          f"x[8:32] for off = 1; {ms * 1e3:.2f} us per launch (CUDA events, "
          f"launch included) {stamp}")
    return ms


def run_all(dev, stamp: str) -> dict:
    f32 = probe_f32(dev, stamp)
    bf16 = probe_bf16(dev, stamp, f32["take"])
    return {"f32": f32, "take_bf16": bf16, "dynslice_ms": probe_bf16_dynslice(dev, stamp)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the CUDA device to time (default cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        ap.error("the probes time the card: --device must name a CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    torch.cuda.set_device(index)
    run_all(dev, f"[{profiling.card_line(index)}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
