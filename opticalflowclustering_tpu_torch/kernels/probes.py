"""The gather-cost probe kernels on the card (port of the four Pallas probe
kernels in `scripts/gather_cost_probe.py` and `scripts/profile_r4.py`).

Two kernels, written by hand for sm_90a in `csrc/probes.cu`:

  loop_probe (replaces `make(op, n).run`, gather_cost_probe.py:34;
             `make_bf16_take(n).run`, :94; `_loop_kernel(body, n).run`,
             profile_r4.py:72) — acc = acc + g(x0 + i) for i < n on a
             [rows, 128] tile, for one of the bodies g in BODIES:
               mul                 (x0 + i) · f32(1.0001)
               where               where(idx > 64, x0 + i, acc)
               take                (x0 + i)[idx] along the last axis
               take_bf16           as take, with x0 bf16: bf16(x0 + bf16(i))
                                   gathered, then widened to float32
               two_takes           (x0 + i)[idx] + (x0 · f32(1.0001) + i)[idx]
               packed_take_unpack  u = bits of (x0 + i)[idx] as int32;
                                   f32(u & 0xFFFF) + f32(u >>> 16)
  dynslice   (replaces `probe_bf16_dynslice.run`, gather_cost_probe.py:133)
             — the 24-row window of a bf16 [80, 128] tile that starts at row
             rem(off, 8) · 8, widened to float32, with `off` read on the
             device.

They are microbenchmarks: the scripts in `scripts/` time `loop_probe` by
the slope between two trip counts and `dynslice` by replaying a CUDA graph
of many launches. `loop_probe` and `dynslice` are the wrappers: for a CPU
tensor they run the plain versions (`loop_probe_reference`,
`dynslice_reference`); for a CUDA tensor they launch the kernel or raise.
`kernels.LAUNCHES` counts their launches (a call captured into a CUDA graph
counts once, when it is captured). The kernel equals its plain version bit for bit
(see `csrc/probes.cu` for the order of operations and its stage groups of
UNROLL iterations).

Beside each body's ALU bound (`loop_probe_cost`), `loop_probe_bounds_ns`
gives the two others a redesign of the same loop is held to: the dependent
chain through `acc`, and the least shared-memory traffic of the take bodies;
`gather_wavefronts` counts what an actual `idx` tile costs in bank conflicts.
"""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch import kernels
from opticalflowclustering_tpu_torch.kernels.build import build
from opticalflowclustering_tpu_torch.runtime import f32
from opticalflowclustering_tpu_torch.utils.profiling import F32_OPS_PER_S

ROWS, LANES = 80, 128  # the probes' tile
WINDOW = 24  # rows of the dynslice window
MAX_N = 1 << 24  # trip counts below this are exact in float32
UNROLL = 16  # iterations per stage group (csrc/probes.cu kUnroll)
BODIES = ("mul", "where", "take", "take_bf16", "two_takes", "packed_take_unpack")
_MUL = f32(1.0001)
# Float32 adds, multiplies and selects that one more iteration adds per
# element, the accumulate included. Work on x0 alone (two_takes' x0 · 1.0001)
# is done once per call and is not counted, nor are gathers (through shared
# memory), conversions and bit operations.
OPS_PER_ITER = {"mul": 3, "where": 3, "take": 2, "take_bf16": 2, "two_takes": 4,
                "packed_take_unpack": 3}

# Ops on each body's loop-carried chain through `acc` per iteration: the add,
# and for `where` the select of acc before it. Each waits for the last, at
# CHAIN_OP_CYCLES (an FP32 add's or select's dependent-issue latency on sm_90).
CHAIN_OPS = {"mul": 1, "where": 2, "take": 1, "take_bf16": 1, "two_takes": 1,
             "packed_take_unpack": 1}
CHAIN_OP_CYCLES = 4
# Rows of the tile each body stores to shared memory and gathers back per
# iteration (two_takes: two).
STAGED_ROWS = {"mul": 0, "where": 0, "take": 1, "take_bf16": 1, "two_takes": 2,
               "packed_take_unpack": 1}
SMS = 132  # streaming multiprocessors of one H100 SXM
WARP = 32
BANKS = 32  # shared-memory banks of 4 bytes; one 128-byte wavefront per clock per SM


def loop_probe_cost(body: str, rows: int, n: int) -> tuple[int, int]:
    """(bytes, float32 operations) of one loop_probe call on a [rows, 128]
    tile: x and idx read once, the output written once."""
    x_bytes = 2 if body == "take_bf16" else 4
    return rows * LANES * (x_bytes + 4 + 4), rows * LANES * n * OPS_PER_ITER[body]


def smem_wavefronts(body: str, rows: int) -> int:
    """Least shared-memory wavefronts of one iteration over a [rows, 128]
    tile: per warp, one stored and one gathered 32-lane group per staged row,
    each conflict-free."""
    return rows * (LANES // WARP) * 2 * STAGED_ROWS[body]


def loop_probe_bounds_ns(body: str, rows: int, clock_mhz: float) -> dict[str, float]:
    """Three least times of one iteration in ns, at an SM clock of
    `clock_mhz`: `alu`, the float32 operations over all lanes of the card;
    `chain`, the ops on the acc chain at their latency; `smem`, the least
    wavefronts over every SM at one per clock (0 for mul and where)."""
    return {
        "alu": rows * LANES * OPS_PER_ITER[body] / F32_OPS_PER_S * 1e9,
        "chain": CHAIN_OPS[body] * CHAIN_OP_CYCLES / clock_mhz * 1e3,
        "smem": smem_wavefronts(body, rows) / SMS / clock_mhz * 1e3,
    }


def gather_wavefronts(body: str, idx: torch.Tensor) -> tuple[int, float]:
    """What the gathers of one iteration cost in shared memory for this
    `idx` ([rows, 128], clamped to [0, 128)): (the busiest row's wavefronts,
    its stores included, which one SM serves alone in the one-row-per-block
    layout; the mean wavefronts of one warp's gather). A warp's gather takes
    as many wavefronts as its busiest bank holds distinct 4-byte words among
    the lanes it reads (equal words are broadcast); a bf16 lane is half a
    word. (0, 0.0) for mul and where, which stage nothing."""
    staged = STAGED_ROWS[body]
    if not staged:
        return 0, 0.0
    elem_bytes = 2 if body == "take_bf16" else 4
    words = LANES * elem_bytes // 4
    j = idx.clamp(0, LANES - 1).long().reshape(idx.shape[0], LANES // WARP, WARP)
    present = torch.zeros(j.shape[:2] + (words,), dtype=torch.int64)
    present.scatter_(-1, j * elem_bytes // 4, 1)
    per_warp = present.reshape(j.shape[:2] + (words // BANKS, BANKS)).sum(-2).amax(-1)
    busiest = staged * int((LANES // WARP + per_warp.sum(-1)).max())
    return busiest, float(per_warp.double().mean())


def dynslice_cost() -> tuple[int, int]:
    """(bytes, float32 operations) of one dynslice call: the offset and the
    bf16 window read, the float32 window written; widening is no arithmetic."""
    return 4 + WINDOW * LANES * (2 + 4), 0


def _bf16(v: float) -> float:
    """`v` rounded to bf16 (nearest even), as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32).to(torch.bfloat16))


def _take(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, j)


def _packed_unpack(g: torch.Tensor) -> torch.Tensor:
    u = g.view(torch.int32)
    # torch's >> on int32 is arithmetic: mask to make it the logical shift.
    return (u & 0xFFFF).float() + ((u >> 16) & 0xFFFF).float()


_G = {
    "mul": lambda x, j, i, acc: (x + i) * _MUL,
    "where": lambda x, j, i, acc: torch.where(j > 64, x + i, acc),
    "take": lambda x, j, i, acc: _take(x + i, j),
    "take_bf16": lambda x, j, i, acc: _take(
        (x.float() + _bf16(i)).to(torch.bfloat16), j
    ).float(),
    "two_takes": lambda x, j, i, acc: _take(x + i, j) + _take(x * _MUL + i, j),
    "packed_take_unpack": lambda x, j, i, acc: _packed_unpack(_take(x + i, j)),
}


def _check_loop_args(body: str, x: torch.Tensor, idx: torch.Tensor, n: int) -> None:
    if body not in BODIES:
        raise ValueError(f"unknown loop_probe body {body!r} (one of {BODIES})")
    want = torch.bfloat16 if body == "take_bf16" else torch.float32
    if x.dtype != want:
        raise ValueError(f"{body}: x must be {want}, got {x.dtype}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32, got {idx.dtype}")
    if x.ndim != 2 or x.shape[0] < 1 or x.shape[1] != LANES:
        raise ValueError(f"x must be [rows, {LANES}], got {tuple(x.shape)}")
    if idx.shape != x.shape:
        raise ValueError(f"idx has shape {tuple(idx.shape)}, expected {tuple(x.shape)}")
    if not 0 <= n < MAX_N:
        raise ValueError(f"loop_probe needs 0 <= n < 2^24, got {n}")


def _check_dynslice_args(x: torch.Tensor, off: torch.Tensor) -> None:
    if x.dtype != torch.bfloat16 or tuple(x.shape) != (ROWS, LANES):
        raise ValueError(f"x must be bf16 [{ROWS}, {LANES}], got {x.dtype} {tuple(x.shape)}")
    if off.dtype != torch.int32 or tuple(off.shape) != (1,):
        raise ValueError(f"off must be int32 [1], got {off.dtype} {tuple(off.shape)}")


def _check_cuda(name: str, t: torch.Tensor, device) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def loop_probe_reference(
    body: str, x: torch.Tensor, idx: torch.Tensor, n: int
) -> torch.Tensor:
    """Plain version of the loop_probe kernel: acc = acc + g(x0 + i) for
    i < n, one whole-tile PyTorch step per iteration. x: [rows, 128] float32
    (bf16 for take_bf16); idx: [rows, 128] int32, clamped to [0, 128)
    → float32 [rows, 128]."""
    _check_loop_args(body, x, idx, n)
    g = _G[body]
    j = idx.clamp(0, LANES - 1).long()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(n):
        acc = acc + g(x, j, float(i), acc)
    return acc


def dynslice_reference(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Plain version of the dynslice kernel: rows start..start+23 of the bf16
    [80, 128] x as float32, start = rem(off, 8) · 8 (truncating, as C's %)
    clamped to [0, 56]. Reads `off` without a host round trip."""
    _check_dynslice_args(x, off)
    start = (torch.fmod(off.long(), 8) * 8).clamp(0, ROWS - WINDOW)
    rows = start + torch.arange(WINDOW, device=x.device)
    return x.index_select(0, rows).float()


def loop_probe_cuda(
    body: str, x: torch.Tensor, idx: torch.Tensor, n: int
) -> torch.Tensor:
    """Launch the loop_probe kernel with body `body` on contiguous CUDA
    tensors x [rows, 128] (float32; bf16 for take_bf16) and idx
    [rows, 128] int32 → float32 [rows, 128]. 0 <= n < 2^24."""
    _check_loop_args(body, x, idx, n)
    _check_cuda("x", x, x.device)
    _check_cuda("idx", idx, x.device)
    ext = build()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    ext.loop_probe(BODIES.index(body), x, idx, out, n)
    kernels.LAUNCHES["loop_probe"] += 1
    return out


def dynslice_cuda(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Launch the dynslice kernel on a contiguous bf16 CUDA x [80, 128] and
    an int32 CUDA off [1] → float32 [24, 128].

    Any int32 offset is taken: the window starts at row rem(off, 8) · 8,
    clamped to [0, 56], so every off >= 0 gives a start in {0, 8, ..., 56}
    (the JAX probe uses off = 1, the window x[8:32]). The kernel reads off on
    the device in stream order: a write to it enqueued earlier on the current
    stream is seen, a write on another stream needs the caller's sync."""
    _check_dynslice_args(x, off)
    _check_cuda("x", x, x.device)
    _check_cuda("off", off, x.device)
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned (the kernel loads 8 bf16 at a time)")
    ext = build()
    out = torch.empty((WINDOW, LANES), dtype=torch.float32, device=x.device)
    ext.dynslice(x, off, out)
    kernels.LAUNCHES["dynslice"] += 1
    return out


def loop_probe(body: str, x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """acc [rows, 128]: the plain version for CPU tensors, else the kernel."""
    if x.device.type == "cpu":
        return loop_probe_reference(body, x, idx, n)
    return loop_probe_cuda(body, x, idx, n)


def dynslice(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """The [24, 128] float32 window: the plain version for CPU tensors, else
    the kernel."""
    if x.device.type == "cpu":
        return dynslice_reference(x, off)
    return dynslice_cuda(x, off)
