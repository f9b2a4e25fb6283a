"""PyTorch port vs the JAX package: the gather-cost probe kernels
(opticalflowclustering_tpu_torch.kernels.probes ↔ the Pallas kernels of
scripts/gather_cost_probe.py and scripts/profile_r4.py) and profile_r4's
experiment C arithmetic (opticalflowclustering_tpu_torch.scripts.profile_r4
↔ scripts/profile_r4.py).

The JAX side is the Pallas kernels themselves, loaded from the scripts and
run in interpret mode on the CPU. XLA's CPU backend contracts a multiply
that feeds an add inside one fused loop into a fused multiply-add, which
rounds once where the Pallas source (and the CUDA kernel, built with
--fmad=false) rounds the product and then the sum; the interpreted kernels
are therefore compiled without XLA's fusion pass, so that every operation
rounds where the source writes it, and every probe is held bitwise. The
CUDA kernels are held to these plain versions on the card by chip_smoke.py.
"""

import functools
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch import kernels
from opticalflowclustering_tpu_torch.kernels import probes
from opticalflowclustering_tpu_torch.scripts import profile_r4 as pr4

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNFUSED = {"xla_disable_hlo_passes": "fusion"}
TRIPS = (1, 7, 64)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "scripts", f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_scripts():
    return _load("gather_cost_probe"), _load("profile_r4")


@pytest.fixture
def interpret(jax_scripts, monkeypatch):
    """Both scripts' pallas_call in interpret mode for this test; records
    each (kernel, keyword arguments) it is called with."""
    gcp, _ = jax_scripts
    calls = []
    orig = gcp.pl.pallas_call

    def interpreted(kernel, **kw):
        calls.append((kernel, kw))
        return orig(kernel, interpret=True, **kw)

    monkeypatch.setattr(gcp.pl, "pallas_call", interpreted)
    return calls


def _run_unfused(run, *args):
    return np.asarray(run.lower(*args).compile(compiler_options=UNFUSED)(*args))


def _inputs(dtype=jnp.float32):
    """The scripts' inputs: x ~ N(0, 1) [80, 128] and idx in [0, 128), seed 0."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((80, 128)), dtype)
    idx = rng.integers(0, 128, (80, 128)).astype(np.int32)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    )
    return x, jnp.asarray(idx), xt, torch.from_numpy(idx)


@pytest.mark.parametrize("n", TRIPS)
@pytest.mark.parametrize("op", ["mul", "where", "take"])
def test_make_op_matches_pallas(jax_scripts, interpret, op, n):
    """loop_probe(op) ↔ gather_cost_probe.make(op, n).run, bitwise."""
    gcp, _ = jax_scripts
    x, idx, xt, it = _inputs()
    want = _run_unfused(gcp.make(op, n), x, idx)
    got = probes.loop_probe(op, xt, it, n).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", TRIPS)
def test_make_bf16_take_matches_pallas(jax_scripts, interpret, n):
    """loop_probe('take_bf16') ↔ gather_cost_probe.make_bf16_take(n).run,
    bitwise: bf16(i) rounds to nearest even, the add is rounded once to bf16
    from float32, the gathered value is widened before the accumulate."""
    gcp, _ = jax_scripts
    x, idx, xt, it = _inputs(jnp.bfloat16)
    want = _run_unfused(gcp.make_bf16_take(n), x, idx)
    got = probes.loop_probe("take_bf16", xt, it, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_probe_rounds_i_to_nearest_even():
    """The bf16 probe's i exceeds bf16's 8-bit significand: bf16(i) rounds
    to nearest even (257 → 256, 259 → 260) before the add."""
    assert probes._bf16(257.0) == 256.0 and probes._bf16(259.0) == 260.0
    x = torch.zeros((1, 128), dtype=torch.bfloat16)
    idx = torch.arange(128, dtype=torch.int32)[None]
    # sum of bf16(i) for i < 260
    want = sum(probes._bf16(float(i)) for i in range(260))
    assert probes.loop_probe("take_bf16", x, idx, 260)[0, 0].item() == want


@pytest.fixture(scope="module")
def experiment_a_bodies(jax_scripts):
    """The two loop bodies of profile_r4.experiment_a_packed_takes, caught
    from its calls of per_op (the experiment itself is not timed)."""
    _, r4 = jax_scripts
    bodies = {}

    def catch(body, x, idx):
        bodies[body.__name__] = body
        return 1.0

    orig = r4.per_op
    r4.per_op = catch
    try:
        r4.experiment_a_packed_takes()
    finally:
        r4.per_op = orig
    return bodies


@pytest.mark.parametrize("n", TRIPS)
@pytest.mark.parametrize("body", ["two_takes", "packed_take_unpack"])
def test_loop_kernel_bodies_match_pallas(jax_scripts, experiment_a_bodies, interpret, body, n):
    """loop_probe(body) ↔ profile_r4._loop_kernel(body, n).run, bitwise.
    packed_take_unpack shifts the int32 bits logically (lax's
    shift_right_logical; the port masks torch's arithmetic >>)."""
    _, r4 = jax_scripts
    x, idx, xt, it = _inputs()
    want = _run_unfused(r4._loop_kernel(experiment_a_bodies[body], n), x, idx)
    got = probes.loop_probe(body, xt, it, n).numpy()
    np.testing.assert_array_equal(got, want)


def test_packed_unpack_shifts_logically():
    """A negative float's int32 bits have the sign bit set: the high half
    unpacks to 0x8000 + ..., not to a negative number."""
    g = torch.tensor([-1.0, 1.5, -0.0], dtype=torch.float32)
    u = g.view(torch.int32).numpy().view(np.uint32)
    want = (u & 0xFFFF).astype(np.float32) + (u >> 16).astype(np.float32)
    np.testing.assert_array_equal(probes._packed_unpack(g).numpy(), want)


@pytest.fixture
def dynslice_kernel(jax_scripts, interpret):
    """The Pallas kernel of probe_bf16_dynslice (caught from the script's own
    run, which checks off = 1) as a jitted function of (x, off)."""
    gcp, _ = jax_scripts
    gcp.probe_bf16_dynslice()
    kernel, kw = interpret[-1]
    return jax.jit(lambda x, off: gcp.pl.pallas_call(kernel, **kw)(x, off))


@pytest.mark.parametrize("off", range(16))
def test_dynslice_matches_pallas(dynslice_kernel, off):
    """dynslice ↔ probe_bf16_dynslice's kernel, bitwise, for off in 0..15
    (windows starting at rows 0, 8, ..., 56)."""
    x, _, xt, _ = _inputs(jnp.bfloat16)
    want = np.asarray(dynslice_kernel(x, jnp.asarray([off], jnp.int32)))
    got = probes.dynslice(xt, torch.tensor([off], dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(got, want)
    if off == 1:
        np.testing.assert_array_equal(got, xt[8:32].float().numpy())


def test_dynslice_negative_offsets_clamp_to_row_0():
    """A negative off gives a negative start (rem truncates); the port clamps
    it to row 0, as lax.dynamic_slice clamps (the TPU kernel reads outside
    the tile there)."""
    x = torch.arange(80 * 128, dtype=torch.float32).reshape(80, 128).to(torch.bfloat16)
    for off in (-1, -7, -9):
        got = probes.dynslice(x, torch.tensor([off], dtype=torch.int32))
        torch.testing.assert_close(got, x[:24].float(), rtol=0, atol=0)
    for off in (8, 9, 2**31 - 1):
        start = (off % 8) * 8
        got = probes.dynslice(x, torch.tensor([off], dtype=torch.int32))
        torch.testing.assert_close(got, x[start:start + 24].float(), rtol=0, atol=0)


def test_experiment_c_matches_jax_arithmetic(jax_scripts, capsys):
    """profile_r4.experiment_c_accounting on fixed inputs prints the JAX
    function's numbers (ms/pair, fast16 delta, Δ/0.4 share, M-merge share)
    to the digits JAX prints them."""
    _, r4 = jax_scripts
    saving = 12.7e-6
    d_times = {("fast", "smooth"): 3.957e-3, ("fast16", "smooth"): 4.094e-3,
               ("fast", "noise"): 5.1e-3, ("fast16", "noise"): 3.2e-3}
    r4.experiment_c_accounting(saving, d_times)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    got = pr4.experiment_c_accounting(saving, d_times, 10.0, 0.2)
    for kind, line in zip(("smooth", "noise"), jax_lines):
        m = re.search(r"C\. (\w+): ([-\d.]+) ms/pair; fast16 delta ([-\d.]+) ms/pair .*?"
                      r"~(-?\d+)% .*covers ([-\d.]+)%", line)
        assert m and m.group(1) == kind, line
        g = got[kind]
        assert f"{g['per_pair_ms']:.2f}" == m.group(2)
        assert f"{g['delta_ms']:.2f}" == m.group(3)
        assert f"{g['share_pct']:.0f}" == m.group(4)
        assert f"{g['merge_pct']:.1f}" == m.group(5)


def test_experiment_c_measured_accounting():
    """The port's measured accounting: per-take ns over the tile's 10240
    lanes × 20 corner loads per pixel × the batch's pixels, as a share of
    warp_m's time."""
    d = {(m, k): 4e-3 for m in ("fast", "fast16") for k in ("smooth", "noise")}
    out = pr4.experiment_c_accounting(1e-5, d, 10.24, 0.2)
    pixels = pr4.WARP_BATCH * pr4.H * pr4.W
    assert out["gather_ms"] == pytest.approx(10.24e-6 / 10240 * 20 * pixels)
    assert out["gather_share_pct"] == pytest.approx(100 * out["gather_ms"] / 0.2)


def test_wrappers_take_cpu_tensors_and_check_their_inputs():
    """On CPU tensors the wrappers run the plain versions and count no
    launch; the CUDA entries refuse CPU tensors before any build; malformed
    inputs raise in both."""
    x = torch.zeros((80, 128))
    idx = torch.zeros((80, 128), dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    assert probes.loop_probe("mul", x, idx, 3).shape == (80, 128)
    assert probes.dynslice(x.to(torch.bfloat16), torch.tensor([1], dtype=torch.int32)).shape == (24, 128)
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        probes.loop_probe_cuda("take", x, idx, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        probes.dynslice_cuda(x.to(torch.bfloat16), torch.tensor([1], dtype=torch.int32))
    bad = [
        (("gather", x, idx, 3), "unknown"),
        (("take_bf16", x, idx, 3), "bfloat16"),
        (("take", x, idx.long(), 3), "int32"),
        (("take", x[:, :64], idx[:, :64], 3), r"\[rows, 128\]"),
        (("take", x, idx[:40], 3), "shape"),
        (("take", x, idx, 1 << 24), "2\\^24"),
        (("take", x, idx, -1), "2\\^24"),
    ]
    for args, match in bad:
        for fn in (probes.loop_probe, probes.loop_probe_cuda):
            with pytest.raises(ValueError, match=match):
                fn(*args)
    with pytest.raises(ValueError, match="bf16"):
        probes.dynslice(x, torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="int32"):
        probes.dynslice(x.to(torch.bfloat16), torch.tensor([1, 2], dtype=torch.int32))
    assert kernels.LAUNCHES == before


def test_out_of_range_indices_are_clamped():
    """idx outside [0, 128) reads lane 0 or lane 127, in the plain version as
    in the kernel."""
    x = torch.arange(128, dtype=torch.float32)[None].repeat(2, 1)
    idx = torch.full((2, 128), 500, dtype=torch.int32)
    idx[1] = -3
    got = probes.loop_probe("take", x, idx, 1)
    assert got[0].eq(127).all() and got[1].eq(0).all()


def test_probe_costs_and_bounds():
    """The bytes and float32 operations chip_smoke.py prices each probe call
    at: x, idx and the output once for loop_probe, with OPS_PER_ITER[body]
    per element and iteration; the offset and the window for dynslice."""
    from opticalflowclustering_tpu_torch.utils.profiling import bound_ms

    assert probes.OPS_PER_ITER == {"mul": 3, "where": 3, "take": 2, "take_bf16": 2,
                                   "two_takes": 4, "packed_take_unpack": 3}
    assert probes.loop_probe_cost("take", 80, 256) == (80 * 128 * 12, 80 * 128 * 256 * 2)
    # two_takes: x0 + i, (x0 · 1.0001) + i, their sum and the accumulate; the
    # loop-invariant x0 · 1.0001 is not charged per iteration.
    assert probes.loop_probe_cost("two_takes", 80, 10)[1] == 80 * 128 * 10 * 4
    # chip_smoke.py's per-iteration bound (one more iteration moves no byte).
    per_iter_ns = bound_ms(0, probes.loop_probe_cost("two_takes", 80, 1)[1])[0] * 1e6
    assert per_iter_ns == pytest.approx(1.2226, abs=1e-4)
    assert probes.loop_probe_cost("take_bf16", 80, 1) == (80 * 128 * 10, 80 * 128 * 2)
    assert probes.dynslice_cost() == (4 + 24 * 128 * 6, 0)
    assert bound_ms(*probes.loop_probe_cost("mul", 80, 256))[1] == "operations"
    assert bound_ms(*probes.dynslice_cost())[1] == "bytes"


# --- the Hopper design of csrc/probes.cu: its bounds and its arithmetic -----

U = probes.UNROLL
SRC = os.path.join(REPO, "opticalflowclustering_tpu_torch", "kernels", "csrc", "probes.cu")


def test_unroll_matches_the_kernel_source():
    """probes.UNROLL (the trip counts chip_smoke.py checks are built on it) is
    the kernel's stage-group length."""
    with open(SRC) as f:
        m = re.search(r"constexpr int kUnroll = (\d+);", f.read())
    assert m and int(m.group(1)) == U


# body: (busiest row's wavefronts per iteration, mean per warp gather,
#        ALU, chain and shared-memory bounds in ns per iteration at 1980 MHz)
SEED0_BOUNDS = {
    "mul": (0, 0.0, 0.9170, 2.0202, 0.0),
    "where": (0, 0.0, 0.9170, 4.0404, 0.0),
    "take": (17, 2.771875, 0.6113, 2.0202, 2.4487),
    "take_bf16": (12, 2.0, 0.6113, 2.0202, 2.4487),
    "two_takes": (34, 2.771875, 1.2226, 2.0202, 4.8974),
    "packed_take_unpack": (17, 2.771875, 0.9170, 2.0202, 2.4487),
}


@pytest.mark.parametrize("body", probes.BODIES)
def test_probe_bounds_for_the_seed0_tile(body):
    """The three bounds chip_smoke.py prints for each body, and the bank
    conflicts of the scripts' seed-0 idx: a float32 warp gather averages
    2.77 wavefronts (its busiest row 13 over 4 warps, plus 4 for the
    stores), a bf16 one 2 (8 a row). The largest bound is what a body's
    share is taken against."""
    _, _, _, idx = _inputs()
    busiest, per_warp, alu, chain, smem = SEED0_BOUNDS[body]
    assert probes.gather_wavefronts(body, idx) == (busiest, pytest.approx(per_warp))
    b = probes.loop_probe_bounds_ns(body, 80, 1980.0)
    assert b == {"alu": pytest.approx(alu, abs=1e-4), "chain": pytest.approx(chain, abs=1e-4),
                 "smem": pytest.approx(smem, abs=1e-4)}
    assert probes.smem_wavefronts(body, 80) == 80 * 4 * 2 * probes.STAGED_ROWS[body]


def test_gather_wavefronts_broadcast_and_conflicts():
    """Lanes reading one word are served at once; distinct words of one bank
    take one wavefront each, at most 4 for float32 (128 words) and 2 for
    bf16 (two lanes a word)."""
    same = torch.zeros((1, 128), dtype=torch.int32)
    assert probes.gather_wavefronts("take", same) == (4 + 4, 1.0)
    stride = (torch.arange(128, dtype=torch.int32) * 32 % 128)[None]  # lanes 0, 32, 64, 96, ...
    assert probes.gather_wavefronts("take", stride) == (4 + 16, 4.0)
    assert probes.gather_wavefronts("take_bf16", stride) == (4 + 8, 2.0)
    assert probes.gather_wavefronts("take", torch.arange(128, dtype=torch.int32)[None]) == (8, 1.0)


def _counter(lo, hi):
    """The kernel's float counter for iterations lo..hi-1: a group base fb,
    the float32 sum of UNROLL.0f per group, plus the constant k < UNROLL."""
    g = np.arange(lo // U, -(-hi // U))
    fb = np.concatenate([[0], np.cumsum(np.full(g[-1], U, np.float32), dtype=np.float32)])[g]
    fi = (fb[:, None] + np.arange(U, dtype=np.float32)[None]).astype(np.float32).ravel()
    return fi[lo - g[0] * U: hi - g[0] * U]


@pytest.mark.parametrize("lo,hi", [(0, 1 << 20), ((1 << 24) - (1 << 16), probes.MAX_N)])
def test_float_counter_is_exact(lo, hi):
    """fb + k, with fb incremented by UNROLL.0f a group, is float32(i) for
    every i below a large n and at the top of the range below 2^24; so is
    the tail's fi += 1.0f from the last group's base."""
    i = np.arange(lo, hi)
    np.testing.assert_array_equal(_counter(lo, hi), i.astype(np.float32))
    fi = np.float32(hi - U)
    for t in range(U):
        assert fi == np.float32(hi - U + t)
        fi = np.float32(fi + np.float32(1.0))


def _small_uint_to_float(k):
    """csrc/probes.cu small_uint_to_float: the bits 0x4B000000 | k are the
    float 2^23 + k; subtracting 2^23 leaves k exactly."""
    return (np.uint32(0x4B000000) | k.astype(np.uint32)).view(np.float32) - np.float32(8388608.0)


@pytest.mark.parametrize("case", ["every_half", "unpack_of_loop_values"])
def test_exponent_bits_conversion(case):
    """The exponent-bits conversion is float(k) for all 65,536 16-bit
    halves, and the kernel's unpack built on it is the plain version's on
    the rows the loop gathers."""
    if case == "every_half":
        k = np.arange(1 << 16, dtype=np.uint32)
        np.testing.assert_array_equal(_small_uint_to_float(k), k.astype(np.float32))
        return
    _, _, xt, _ = _inputs()
    for i in (0.0, 1.0, 255.0, 33999.0, float((1 << 24) - 1)):
        g = xt + i
        u = g.numpy().view(np.uint32)
        got = _small_uint_to_float(u & 0xFFFF) + _small_uint_to_float(u >> 16)
        np.testing.assert_array_equal(got, probes._packed_unpack(g).numpy())


def _bf16_rn_high(v):
    """The float32 bits rounded to bf16, nearest even, by integer operations
    (finite v): the rounding of the kernel's cvt.rn.bf16x2.f32 and
    cvt.rn.bf16.f32, modelled for _grouped_loop."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return (u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)


def _ties():
    """Floats exactly halfway between two bf16 values: bf16 bits b (even and
    odd) with 0x8000 below them, both signs, up to the one that rounds to
    infinity; and the float32 extremes."""
    b = np.array([0x0000, 0x0001, 0x3F80, 0x3F81, 0x4300, 0x4301, 0x7F7E, 0x7F7F, 0x0080], np.uint32)
    u = np.concatenate([(b << 16) | 0x8000, ((b | 0x8000) << 16) | 0x8000])
    extremes = np.array([0x7F7FFFFF, 0xFF7FFFFF, 0x00000001, 0x7F800000, 0xFF800000], np.uint32)
    return np.concatenate([u, extremes]).view(np.float32)


@pytest.mark.parametrize("case", ["counters", "sums", "ties"])
def test_integer_bf16_rounding_matches_torch(case):
    """The integer model of nearest-even rounding is torch's float32 →
    bfloat16 for the counters the loop rounds (every i < 2^17 and near
    2^24), for the sums it rounds (x0 + bf16(i) of the seed-0 bf16 tile) and
    for ties, so the model below rounds as the kernel does."""
    if case == "counters":
        v = np.concatenate([np.arange(1 << 17), np.arange(probes.MAX_N - 4096, probes.MAX_N)]).astype(np.float32)
    elif case == "sums":
        x0 = _inputs(jnp.bfloat16)[2].float().numpy().ravel()
        ib = np.array([probes._bf16(float(i)) for i in range(0, 40000, 97)], np.float32)
        v = (x0[None] + ib[:, None]).astype(np.float32).ravel()
    else:
        v = _ties()
    want = torch.from_numpy(v).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(_bf16_rn_high(v) >> 16, want.astype(np.uint32))


def _row_ops(body, x, j):
    """(put, load, value) of a staged body in csrc/probes.cu, on torch rows:
    what one iteration stores, what its gather reads, what is added to acc."""
    gather = functools.partial(torch.gather, dim=-1, index=j)
    if body == "take_bf16":
        xf = x.float()

        def put(fi):
            ib = float(_bf16_rn_high([fi]).view(np.float32)[0])
            v = (xf + ib).numpy()
            return torch.from_numpy((_bf16_rn_high(v) >> 16).astype(np.int64))

        return put, gather, lambda v: torch.from_numpy((v.numpy().astype(np.uint32) << 16).view(np.float32))
    if body == "two_takes":
        xm = x * probes._MUL
        return (lambda fi: (x + fi, xm + fi), lambda s: (gather(s[0]), gather(s[1])),
                lambda v: v[0] + v[1])
    if body == "packed_take_unpack":
        def unpack(v):
            u = v.numpy().view(np.uint32)
            return torch.from_numpy(_small_uint_to_float(u & 0xFFFF) + _small_uint_to_float(u >> 16))

        return (lambda fi: x + fi), gather, unpack
    return (lambda fi: x + fi), gather, (lambda v: v)


def _grouped_loop(body, x, idx, n):
    """A Python model of csrc/probes.cu's loops. Staged bodies: stage groups
    of UNROLL iterations, each stored into one of two alternating buffer
    sets, then gathered after the group's barrier, its values added to acc
    after the next group's gathers; the n mod UNROLL iterations left over
    as one short group at the end. A set is stored only after its last
    gathers were a barrier back (the barrier of the group before). mul and
    where: the loop
    unrolled by UNROLL with its fi += 1 tail. Both with the float counter."""
    j = idx.clamp(0, 127).long()
    acc = torch.zeros(x.shape, dtype=torch.float32)
    full, rem = divmod(n, U)
    fb = np.float32(0.0)
    if probes.STAGED_ROWS[body] == 0:
        g = probes._G[body]
        for _ in range(full):
            for k in range(U):
                acc = acc + g(x, j, float(np.float32(fb + np.float32(k))), acc)
            fb = np.float32(fb + np.float32(U))
        fi = fb
        for _ in range(rem):
            acc = acc + g(x, j, float(fi), acc)
            fi = np.float32(fi + np.float32(1.0))
        return acc
    put, load, value = _row_ops(body, x, j)
    stage, last_read, held = [[None] * U, [None] * U], [-2, -2], []
    for grp in range(full + (rem > 0)):
        count, s = (U if grp < full else rem), grp % 2
        assert last_read[s] <= grp - 2  # read in group grp - 2, before the barrier of grp - 1
        for k in range(count):
            stage[s][k] = put(float(np.float32(fb + np.float32(k))))
        fb = np.float32(fb + np.float32(U))
        got = [load(stage[s][k]) for k in range(count)]
        last_read[s] = grp
        for v in held:
            acc = acc + value(v)
        held = got
    for v in held:
        acc = acc + value(v)
    return acc


@pytest.mark.parametrize("n", range(2 * U + 2))
@pytest.mark.parametrize("body", probes.BODIES)
def test_grouped_loop_model_matches_the_plain_loop(body, n):
    """The kernel's order of operations (stage groups of UNROLL, each added
    after the next group's gathers, the short last group, the float counter,
    the roundings and the exponent-bits unpack) gives the plain loop's acc
    bit for bit, for every n from 0 to 2U + 1."""
    dtype = jnp.bfloat16 if body == "take_bf16" else jnp.float32
    _, _, xt, it = _inputs(dtype)
    got = _grouped_loop(body, xt, it, n)
    assert torch.equal(got, probes.loop_probe_reference(body, xt, it, n))
