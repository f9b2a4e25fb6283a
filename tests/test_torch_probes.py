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

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    before = dict(probes.LAUNCHES)
    assert probes.loop_probe("mul", x, idx, 3).shape == (80, 128)
    assert probes.dynslice(x.to(torch.bfloat16), torch.tensor([1], dtype=torch.int32)).shape == (24, 128)
    assert probes.LAUNCHES == before
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
    assert probes.LAUNCHES == before


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
