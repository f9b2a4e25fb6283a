"""The harness on the CPU: every cell at a tiny size, the result line's keys,
finding new cells, mixes and metrics as files, the frozen yardstick, and
what the command loads."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from ofc_bench import run, spec, yardstick
from ofc_bench.tests.helpers import BENCHMARK, CELLS, TESTED, tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_runs_tiny_on_cpu_and_agrees_with_the_reference(name):
    cell = tiny(name)
    result = run.run_cell(cell, 2**31 + 7, 1.0, False, device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())
    assert list(result) == RESULT_KEYS
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end} >= {"setup_s", "pairs_per_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    if "pair_ms" in result["metrics"]:  # the window's time a pair: the rate's reciprocal
        assert result["metrics"]["pair_ms"]["value"] == pytest.approx(1e3 / result["metrics"]["pairs_per_s"]["value"])
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("name", ["bounce720-fast.mem", "bounce720-fast.stream-cv2"])
def test_traced_run_has_the_contract_keys(name):
    result = run.run_cell(tiny(name), 3, 1.0, True, device="cpu")
    assert result["correct"]
    assert list(result) == RESULT_KEYS[:5] + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device on the CPU: every device metric's reader finds nothing to read.
    assert "device_idle_pct" not in result["metrics"] and "warp_m_roofline" not in result["metrics"]


def test_traced_queue_run_reports_its_clip_p90():
    cell = tiny("bounce720-fast.queue-dp2sp2")
    result = run.run_cell(cell, 2**31 + 13, 1.0, True, device="cpu")
    assert result["correct"], result["checks"]
    assert [m["name"] for m in cell.end_to_end] == ["pairs_per_s", "setup_s"]
    assert result["metrics"]["queue_clip_p90_ms"]["value"] > 0
    assert result["metrics"]["queue_clip_p90_ms"]["unit"] == "ms"


def test_same_seed_same_clips_other_seed_other_clips():
    from ofc_bench import clips

    cell = tiny("bounce720-fast.mem")
    a = clips.make_clips(cell.config, cell.traffic, 2**32 + 5)
    b = clips.make_clips(cell.config, cell.traffic, 2**32 + 5)
    c = clips.make_clips(cell.config, cell.traffic, 6)
    assert all((x == y).all() for x, y in zip(a, b))
    assert any((x != y).any() for x, y in zip(a, c))
    assert [x.shape for x in a] == [x.shape for x in c] == [(11, 96, 128, 3)] * 8


def test_new_config_mix_and_metric_are_found_as_files(tmp_path):
    """A later change adds a cell, its configuration, its mix and a metric
    by adding files and entries, and edits no file of the harness."""
    base = tmp_path / "bench"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    config = json.loads((base / "configs" / "cropflow-fast.json").read_text())
    config["name"] = "cropflow-exact"
    config["farneback"]["warp_mode"] = "exact"
    (base / "configs" / "cropflow-exact.json").write_text(json.dumps(config))
    mix = json.loads((base / "traffic" / "mem.json").read_text())
    mix["source"] = "noise"
    (base / "traffic" / "noise.json").write_text(json.dumps(mix))
    (base / "metrics" / "pairs_traced.py").write_text("def read(view):\n    return float(view.pairs)\n")
    bench = json.loads(json.dumps(BENCHMARK))
    bench["workloads"].append({"name": "cropflow-exact.noise", "config": "cropflow-exact", "traffic": "noise",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "pairs_traced", "unit": "pairs", "better": "higher",
                               "source": "program_counter", "layer": "device", "moves": "pairs_per_s",
                               "workloads": ["cropflow-exact.noise"]})
    cell = tiny("cropflow-exact.noise", bench, base)
    assert cell.config["farneback"]["warp_mode"] == "exact" and cell.traffic["source"] == "noise"
    assert [m["name"] for m in cell.per_layer] == ["pairs_traced"]
    traced = run.run_cell(cell, 11, 1.0, True, device="cpu")
    assert traced["correct"], traced["checks"]
    # 4 traced requests of 10 pairs each
    assert traced["metrics"] == {"pairs_traced": {"value": 40.0, "unit": "pairs"}}
    assert run.run_cell(cell, 12, 0.5, False, device="cpu")["correct"]


@pytest.mark.parametrize("winsize", [1, 7, 15, 17])
@pytest.mark.parametrize("shape", [(16, 720, 1280), (16, 90, 160), (3, 29, 28)])
def test_frozen_counts_equal_the_ports(shape, winsize):
    from opticalflowclustering_tpu_torch.kernels import warp
    from opticalflowclustering_tpu_torch.utils import profiling

    for k in ("warp_m", "box_solve"):
        assert yardstick.kernel_bytes(k, *shape) == warp.kernel_bytes(k, *shape)
        assert yardstick.kernel_ops(k, *shape, winsize) == warp.kernel_ops(k, *shape, winsize)
    assert (yardstick.HBM_BYTES_PER_S, yardstick.F32_OPS_PER_S) == (profiling.HBM_BYTES_PER_S,
                                                                     profiling.F32_OPS_PER_S)
    nbytes, ops = warp.kernel_bytes("box_solve", *shape), warp.kernel_ops("box_solve", *shape, winsize)
    assert yardstick.bound_s(nbytes, ops) == pytest.approx(profiling.bound_ms(nbytes, ops)[0] / 1e3)


_RUN_AND_LIST = """
import sys
import torch
torch.set_num_threads(2)
from ofc_bench import run
from ofc_bench.tests.helpers import tiny
for name in {cells!r}:
    assert run.run_cell(tiny(name), 5, 0.5, name.endswith("mem"), device="cpu")["correct"]
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def test_the_command_loads_nothing_of_jax():
    out = subprocess.run([sys.executable, "-c", _RUN_AND_LIST.format(cells=CELLS)], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=600, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))  # noqa: S307 — a list of names this test printed
    assert "opticalflowclustering_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "ofc_bench.run", "--workload", "bounce720-fast.mem", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_command_in_a_directory_with_only_the_benchmark_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "ofc_bench", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "ofc_bench.run", "--workload", "bounce720-fast.mem", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_on_the_card(cuda, name):
    """One short run of each cell at its full size, where the machine has its cards."""
    import torch

    cell = spec.load_cell(name, TESTED)
    if torch.cuda.device_count() < cell.chips:
        pytest.skip(f"{name} needs {cell.chips} cards")
    result = run.run_cell(cell, 2**31 + 99, 3.0, False, device=cuda)
    assert result["correct"], result["checks"]
