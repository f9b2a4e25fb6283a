"""The port's driver entry points (opticalflowclustering_tpu_torch.graft_entry
↔ __graft_entry__.py): the multi-device dryrun with every pass's asserts on
a 4-entry CPU mesh, and the forward step against the JAX package's."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from opticalflowclustering_tpu_torch import graft_entry

torch.set_num_threads(1)


def test_dryrun_multichip_on_cpu(capsys):
    """dryrun_multichip(4, device='cpu'): all six passes run their asserts
    on a dp=2×sp=2 mesh (and a tp=4 mesh) naming the CPU four times, print
    one line each in the JAX package's words, and report no kernel launch
    (the plain versions run on the CPU)."""
    launches = graft_entry.dryrun_multichip(4, device="cpu")
    assert list(launches) == ["1", "1.5", "1.6", "1.7", "1.75", "2"]
    assert all(v == {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 0, "pyramid": 0}
               for v in launches.values())
    out = capsys.readouterr().out
    for tag in ("flagship pipeline ok (bitwise) on dp=2×sp=2 mesh — hue table (4, 4, 24)",
                "spatial TP ok (max |Δ| 0.0e+00 px) — 192-row frame across 4 row shards",
                "padded spatial TP ok (720 rows on 4 shards, interior max |Δ| 0.0e+00 px)",
                "spatial-TP hue pipeline ok (feature tables equal)",
                "near-flagship geometry ok (bitwise) — 2x4 frames of 512x128 on dp=2x sp=2",
                "mesh dp=2×sp=2 over 4 devices, one fused train step ok, loss="):
        assert tag in out, tag
    assert out.count("dryrun_multichip: ") == 6


def test_dryrun_mesh_devices():
    """An odd device count runs dp=1; fewer devices than asked for raise;
    without CUDA the default (every visible card) raises."""
    with pytest.raises(ValueError, match="needs 4 devices"):
        graft_entry.dryrun_multichip(4, devices=["cpu"] * 3)
    assert graft_entry._mesh_devices(3, "cpu", None) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            graft_entry.dryrun_multichip(2)
        with pytest.raises(RuntimeError, match="cuda"):
            graft_entry.entry()


def test_entry_forward_matches_jax():
    """entry(device='cpu')'s forward ↔ the JAX entry()'s forward (jitted,
    as its driver runs it) on the same 5 seeded frames at 144×256 (720p is
    slow on one CPU thread): hue and rgb_hue tables bitwise, mean_magnitude
    within rtol 1e-6; entry's own frames are the JAX entry's."""
    fn, (frames,) = graft_entry.entry(device="cpu")
    jfn, (jframes,) = jentry.entry()
    np.testing.assert_array_equal(frames, jframes)
    assert frames.shape == (5, 720, 1280, 3)
    small = np.random.default_rng(0).integers(0, 256, size=(5, 144, 256, 3), dtype=np.uint8)
    got = [t.numpy() for t in fn(small)]
    want = [np.asarray(t) for t in jax.jit(jfn)(small)]
    assert [g.shape for g in got] == [w.shape for w in want] == [(4, 350), (4, 350), (4,)]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
