"""The readings each limit of `compare.py` is set from, for one cell.

    python3 -m ofc_bench.limits --workload <cell> --seeds <n> [<n> ...] [--control 3]

For every seed: the cell's clips, one request of each through the cell's
own entry at the timed sizes (the program), and the plain reference in
float32 over the same inputs; the comparison's numbers of the program are
the lower readings. For the first `--control` seeds the reference is also
run in bfloat16, the precision below the configuration's float32, and put
in the program's place: its numbers are the upper readings. One JSON line
per seed and side, then the largest lower and the smallest upper reading of
each number. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile
import time

import torch

from ofc_bench import clips as clipgen
from ofc_bench import compare, spec
from ofc_bench.entries import ENTRIES


def readings(cell: spec.Cell, seeds: list[int], control: int, device: str, out=sys.stdout) -> dict:
    reference = importlib.import_module(f"ofc_bench.reference.{cell.config['reference']}")
    emit = cell.config["emit_flow_bgr"]
    lower: dict[str, float] = {}
    upper: dict[str, float] = {}
    for n, seed in enumerate(seeds):
        with tempfile.TemporaryDirectory(prefix="ofc_bench-") as workdir:
            t = time.time()
            clips = clipgen.make_clips(cell.config, cell.traffic, seed)
            entry = ENTRIES[cell.traffic["entry"]](cell.config, cell.traffic, clips, workdir, device)
            entry.warm()
            got: dict[int, dict] = {}
            for c in range(len(clips)):
                if c not in got:
                    got.update({d.clip: d.load() for d in entry.submit(c) if d.ok})
            want = {c: reference.clip_tables(entry.reference_input(c), cell.config, device, emit_flow_bgr=emit)
                    for c in range(len(clips))}
            sides = {"program": [(got.get(c, {}), want[c]) for c in want]}
            if n < control:
                sides["control"] = [(reference.clip_tables(entry.reference_input(c), cell.config, device,
                                                           dtype=torch.bfloat16, emit_flow_bgr=emit), want[c])
                                    for c in want]
            for side, pairs in sides.items():
                numbers = compare.compare(pairs)
                acc = lower if side == "program" else upper
                for k, v in numbers.items():
                    acc[k] = max(acc.get(k, v), v) if side == "program" else min(acc.get(k, v), v)
                print(json.dumps({"cell": cell.name, "seed": seed, "side": side, "numbers": numbers,
                                  "seconds": time.time() - t}), file=out, flush=True)
            del entry, got, want, sides
            if device.startswith("cuda"):
                torch.cuda.empty_cache()
    summary = {"cell": cell.name, "seeds": seeds, "control_seeds": seeds[:control], "lower": lower,
               "upper": upper}
    print(json.dumps(summary), file=out, flush=True)
    return summary


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    readings(spec.load_cell(args.workload), args.seeds, args.control, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
