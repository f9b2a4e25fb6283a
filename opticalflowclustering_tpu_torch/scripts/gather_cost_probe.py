"""Microbenchmark: what does one per-element gather cost on the card, against
a select and a multiply of the same shape? (counterpart of
`scripts/gather_cost_probe.py`)

Each probe runs the `loop_probe` kernel (`kernels/csrc/probes.cu`) on one
[80, 128] tile at two trip counts and takes the slope between them, timed
with CUDA events: (t(N_HI) − t(N_LO)) / (N_HI − N_LO) cancels the launch.
It prints ns per iteration on [80, 128] with the card's name and power
limit. On the card one iteration of `take` is a shared-memory store of the
fresh row and a gather from it, in groups of `probes.UNROLL` iterations
behind one barrier, on one wave of 80 blocks: for this tile the busiest
row's bank conflicts set the pace, which is a different thing from the
TPU's intra-vreg lane gather.

`probe_bf16` asks whether a bf16 gather costs less than the f32 one (the
question behind a warp_m that loads R1 as bf16); `probe_bf16_dynslice`
checks the dynamic 8-row window of a bf16 tile whose offset is read on the
device, and times it by replaying a CUDA graph of GRAPH_LAUNCHES launches,
beside a one-element fill timed the same way (the launch floor) and beside
the host-inclusive time of one call.

`--against SRC` (repeatable) also builds another `probes.cu` source, such
as an earlier commit's, with nvcc (`-shared` and the build's flags) into
`.torch_ext_build/against/`, calls its C launchers through ctypes, and
times each body and dynslice in turns with the built kernel (against,
built, built, against), after checking both bitwise against the plain
versions.

    python -m opticalflowclustering_tpu_torch.scripts.gather_cost_probe --device cuda
    python -m opticalflowclustering_tpu_torch.scripts.gather_cost_probe --device cuda \
        --against old/probes.cu
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import hashlib
import os
import subprocess

import numpy as np
import torch

from opticalflowclustering_tpu_torch.kernels import build as kbuild
from opticalflowclustering_tpu_torch.kernels import probes
from opticalflowclustering_tpu_torch.runtime import resolve_device
from opticalflowclustering_tpu_torch.utils import profiling

ROWS, LANES = probes.ROWS, probes.LANES
N_LO, N_HI = 2000, 34000
OPS = ("mul", "where", "take")
GRAPH_LAUNCHES = 200  # launches per captured graph of dynslice and of the floor


def tile(dev, dtype=torch.float32, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """The probes' inputs, as the TPU script makes them: x ~ N(0, 1)
    [80, 128] in `dtype` and idx uniform in [0, 128) int32, from `seed`."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((ROWS, LANES)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, LANES, (ROWS, LANES)).astype(np.int32))
    return x.to(dev, dtype), idx.to(dev)


def per_iter_ns(body: str, x, idx, lo: int, hi: int, run=None) -> float:
    """ns per iteration of `run(body, x, idx, n)` (default `loop_probe`) by
    the slope between lo and hi trip counts; raises if the time does not
    grow with n."""
    run = probes.loop_probe if run is None else run
    return 1e6 * profiling.slope_ms(lambda n: functools.partial(run, body, x, idx, n), lo, hi)


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


def launch_floor_ms(dev) -> float:
    """Device time in ms of one launch of a one-element fill, by graph
    replay: the least a launch costs in a graph of back-to-back kernels."""
    one = torch.zeros(1, device=dev)
    return profiling.graph_ms(lambda: one.fill_(1.0), GRAPH_LAUNCHES)


def probe_bf16_dynslice(dev, stamp: str) -> dict[str, float]:
    """Checks the dynslice kernel's window for off = 1 (rows 8..31) and
    returns its times per launch in ms: `ms` by graph replay, the launch
    floor `floor_ms` beside it, and `host_ms`, one call between CUDA events
    with the host's work included. Raises if the window is wrong."""
    x, _ = tile(dev, torch.bfloat16)
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    if not torch.equal(probes.dynslice(x, off), x[8:32].float()):
        raise RuntimeError("dynslice: the window for off = 1 is not x[8:32]")
    ms = profiling.graph_ms(lambda: probes.dynslice(x, off), GRAPH_LAUNCHES)
    floor = launch_floor_ms(dev)
    host = profiling.event_ms(lambda: probes.dynslice(x, off))
    print(f"bf16 8-row dynamic row window (off read on the device): correct, "
          f"x[8:32] for off = 1; {ms * 1e3:.3f} us per launch, launch floor "
          f"(one-element fill) {floor * 1e3:.3f} us (CUDA graph of "
          f"{GRAPH_LAUNCHES} launches, replayed) {stamp}")
    print(f"bf16 8-row dynamic row window, host-inclusive: {host * 1e3:.2f} us per "
          f"call (CUDA events around one Python call: checks, allocation and "
          f"enqueue included) {stamp}")
    return {"ms": ms, "floor_ms": floor, "host_ms": host}


def run_all(dev, stamp: str) -> dict:
    f32 = probe_f32(dev, stamp)
    bf16 = probe_bf16(dev, stamp, f32["take"])
    return {"f32": f32, "take_bf16": bf16, "dynslice": probe_bf16_dynslice(dev, stamp)}


def build_against(src: str):
    """Compile the probes.cu source `src` with nvcc and the build's flags
    into a shared library under .torch_ext_build/against/ and load it.
    Prints ptxas' register and spill lines."""
    from torch.utils.cpp_extension import CUDA_HOME

    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = kbuild.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"{os.path.basename(src).rsplit('.', 1)[0]}-{digest}.so"
    cmd = [os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc"), *kbuild.NVCC_FLAGS,
           "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-o", str(lib), src]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr[-4000:]}")
    for line in r.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas [{src}]: {line.strip()}")
    so = ctypes.CDLL(str(lib))
    so.ofc_loop_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    so.ofc_dynslice.argtypes = [ctypes.c_void_p] * 4
    so.ofc_loop_probe.restype = so.ofc_dynslice.restype = ctypes.c_int
    return so


def _raise_on(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def against_runs(so):
    """(loop_probe, dynslice) of the library `so`, with the wrappers'
    signatures; they launch on the current stream and count no launch."""

    def loop(body, x, idx, n):
        out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        _raise_on(so.ofc_loop_probe(probes.BODIES.index(body), x.data_ptr(), idx.data_ptr(),
                                    out.data_ptr(), x.shape[0], n,
                                    torch.cuda.current_stream().cuda_stream), "loop_probe")
        return out

    def dyn(x, off):
        out = torch.empty((probes.WINDOW, LANES), dtype=torch.float32, device=x.device)
        _raise_on(so.ofc_dynslice(x.data_ptr(), off.data_ptr(), out.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream), "dynslice")
        return out

    return loop, dyn


def compare_against(dev, stamp: str, src: str) -> dict:
    """The library built from `src` against the built kernels: bitwise
    checks of both against the plain versions (at trip counts around one and
    two stage groups, 256 and 1031), then each body's ns per iteration and
    dynslice's graph-replay time, in turns (against, built, built, against).
    Returns {name: (against times, built times)}."""
    u = probes.UNROLL
    check_n = (0, 1, u - 1, u, u + 1, 2 * u + 1, 256, 1031)
    loop, dyn = against_runs(build_against(src))
    out = {}
    for body in probes.BODIES:
        x, idx = tile(dev, torch.bfloat16 if body == "take_bf16" else torch.float32)
        for n in check_n:
            want = probes.loop_probe_reference(body, x, idx, n)
            if not (torch.equal(loop(body, x, idx, n), want)
                    and torch.equal(probes.loop_probe(body, x, idx, n), want)):
                raise RuntimeError(f"{src} or the built kernel: {body} n={n} is not bitwise")
        runs = {"against": loop, "built": probes.loop_probe}
        t = {k: [] for k in runs}
        for k in ("against", "built", "built", "against"):
            t[k].append(per_iter_ns(body, x, idx, N_LO, N_HI, runs[k]))
        out[body] = (t["against"], t["built"])
        print(f"against {body}: {src} {t['against'][0]:.3f}, {t['against'][1]:.3f} ns/iter; "
              f"built {t['built'][0]:.3f}, {t['built'][1]:.3f} ns/iter (in turns; CUDA events, "
              f"slope {N_LO}->{N_HI}) {stamp}")
    x, _ = tile(dev, torch.bfloat16)
    for o in range(-8, 16):
        off = torch.tensor([o], dtype=torch.int32, device=dev)
        if not torch.equal(dyn(x, off), probes.dynslice_reference(x, off)):
            raise RuntimeError(f"{src}: dynslice off={o} is not bitwise")
    off = torch.tensor([1], dtype=torch.int32, device=dev)
    runs = {"against": dyn, "built": probes.dynslice}
    t = {k: [] for k in runs}
    for k in ("against", "built", "built", "against"):
        t[k].append(profiling.graph_ms(lambda r=runs[k]: r(x, off), GRAPH_LAUNCHES))
    floor = launch_floor_ms(dev)
    out["dynslice"] = (t["against"], t["built"])
    print(f"against dynslice: {src} {t['against'][0] * 1e3:.3f}, {t['against'][1] * 1e3:.3f} us; "
          f"built {t['built'][0] * 1e3:.3f}, {t['built'][1] * 1e3:.3f} us; launch floor "
          f"{floor * 1e3:.3f} us (in turns; CUDA graph of {GRAPH_LAUNCHES} launches) {stamp}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="the CUDA device to time (default cuda)")
    ap.add_argument("--against", action="append", default=[], metavar="SRC",
                    help="another probes.cu source to time in turns with the built one")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        ap.error("the probes time the card: --device must name a CUDA device")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    torch.cuda.set_device(index)
    stamp = f"[{profiling.card_line(index)}]"
    run_all(dev, stamp)
    for src in args.against:
        compare_against(dev, stamp, src)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
