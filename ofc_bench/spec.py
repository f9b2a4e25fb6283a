"""What a run is asked to do: the cell, its configuration, its traffic mix
and its metrics, each found by name.

`BENCHMARK.json` names every cell; a cell names a configuration
(`configs/<config>.json`) and a traffic mix (`traffic/<traffic>.json`); each
per-layer metric is a reader of its own (`metrics/<name>.py`, a function
`read(view)`). Adding any of them is adding a file and an entry.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from collections.abc import Callable

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    base: pathlib.Path = HERE  # where its configuration, traffic and metric files are


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None, base: pathlib.Path = HERE) -> Cell:
    """The cell `name` of `benchmark` (default: `BENCHMARK.json` at the root
    of the checkout), with its configuration and traffic read from `base`."""
    if benchmark is None:
        benchmark = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in benchmark["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=json.loads((base / "configs" / f"{w['config']}.json").read_text()),
        traffic=json.loads((base / "traffic" / f"{w['traffic']}.json").read_text()),
        end_to_end=[m for m in benchmark["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in benchmark["per_layer"] if _applies(m, name)],
        base=base,
    )


def metric_reader(name: str, base: pathlib.Path = HERE) -> Callable:
    """`read(view)` of `metrics/<name>.py`."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"ofc_bench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
