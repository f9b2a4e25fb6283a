"""`correct` comes out false when the timed path is broken underneath, and
when the bfloat16 control stands in for the program (CPU, tiny sizes)."""

from __future__ import annotations

import pytest
import torch

from ofc_bench import compare, limits, run
from ofc_bench.tests.helpers import CELLS, tiny


def _alter_one_answer(monkeypatch):
    """A hue altered where it is produced."""
    from opticalflowclustering_tpu_torch.parallel import temporal
    from opticalflowclustering_tpu_torch.pipeline import bounce

    step = bounce.chunk_step

    @torch.inference_mode()
    def chunk_step(*a, **k):
        out = step(*a, **k)
        out["hue_table"][0, 0] = (out["hue_table"][0, 0] + 1) % 180
        return out

    tables = temporal._hue_tables

    @torch.inference_mode()
    def hue_tables(*a, **k):
        hue, *rest = tables(*a, **k)
        hue[0, 0, 0] = (hue[0, 0, 0] + 1) % 180
        return (hue, *rest)

    monkeypatch.setattr(bounce, "chunk_step", chunk_step)
    monkeypatch.setattr(temporal, "_hue_tables", hue_tables)


def _half_the_batch(monkeypatch):
    """The flow of half of the pairs left out, its place filled from the rest."""
    from opticalflowclustering_tpu_torch.parallel import temporal
    from opticalflowclustering_tpu_torch.pipeline import bounce

    flow = bounce.farneback_flow

    def half(prev, nxt, params):
        n = prev.shape[-3]
        kept = flow(prev[..., : max(n // 2, 1), :, :], nxt[..., : max(n // 2, 1), :, :], params)
        return torch.cat([kept] * 3, dim=-4)[..., :n, :, :, :]

    monkeypatch.setattr(bounce, "farneback_flow", half)
    monkeypatch.setattr(temporal, "farneback_flow", half)


def _state_unchanged(monkeypatch):
    """The solve returns the flow it started from (zero) at every step."""
    from opticalflowclustering_tpu_torch.kernels import warp

    def box_solve(m, winsize):
        z = torch.zeros_like(m[:, 0])
        return z, z.clone()

    monkeypatch.setattr(warp, "box_solve", box_solve)


def _no_exchange(monkeypatch):
    """Each frame block pairs its last frame with its own first: the halo
    from the next card never comes."""
    from opticalflowclustering_tpu_torch.parallel import temporal

    blocks = temporal._block_grays

    def block_grays(videos, devs):
        for i, j, gray_ext in blocks(videos, devs):
            yield i, j, torch.cat([gray_ext[:, :-1], gray_ext[:, :1]], dim=1)

    monkeypatch.setattr(temporal, "_block_grays", block_grays)


FAULTS = {"answer_altered": _alter_one_answer, "half_the_batch": _half_the_batch,
          "state_unchanged": _state_unchanged, "no_exchange": _no_exchange}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    if fault == "no_exchange" and "dp2sp2" not in name:
        pytest.skip("only the cell across cards exchanges frames between them")
    cell = tiny(name)
    FAULTS[fault](monkeypatch)
    result = run.run_cell(cell, 2**31 + 3, 1.0, False, device="cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["bounce720-fast.mem", "cropflow-fast.mem"])
def test_the_bfloat16_control_fails_and_the_program_passes(name):
    cell = tiny(name)
    summary = limits.readings(cell, [4, 2**33 + 9], 1, "cpu")
    assert compare.passed(compare.checks(summary["lower"], cell.config["limits"]))
    assert not compare.passed(compare.checks(summary["upper"], cell.config["limits"]))
    # Every count of the control reads off by far more than the program does.
    assert all(summary["upper"][k] > 0 for k in summary["upper"] if k != "missing")
