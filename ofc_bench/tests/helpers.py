"""Tiny cells for the CPU tests: the committed cells, and every mix under
`traffic/` on a configuration, with their frames cut to 96×128 and their
clips to at most 11 frames (2 pyramid levels, chunks of 4 pairs)."""

from __future__ import annotations

import json

import torch

from ofc_bench import spec

torch.set_num_threads(2)

BENCHMARK = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
# A mix that no committed cell uses yet still runs in the tests, on the
# 720p configuration.
_USED = {w["traffic"] for w in BENCHMARK["workloads"]}
_EXTRA = [{"name": f"bounce720-fast.{p.stem}", "config": "bounce720-fast", "traffic": p.stem, "chips": 1,
           "why": "test"} for p in sorted((spec.HERE / "traffic").glob("*.json")) if p.stem not in _USED]
TESTED = {**BENCHMARK, "workloads": BENCHMARK["workloads"] + _EXTRA}
CELLS = [w["name"] for w in TESTED["workloads"]]


def tiny(name: str, benchmark: dict = TESTED, base=spec.HERE) -> spec.Cell:
    cell = spec.load_cell(name, benchmark, base)
    cell.config.update(height=96, width=128, clip_frames=min(cell.config["clip_frames"], 11), chunk=4)
    return cell
