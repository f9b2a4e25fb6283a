"""Run one cell of the benchmark once and print its result line.

    python3 -m ofc_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the kernel extension loaded from `.torch_ext_build/` in
the checkout, the cell's clips made from the seed, and one warm request)
is timed as `setup_s`. Then a closed loop with one client submits the mix's
clips in turn for `--seconds`: each request as soon as the previous one's
tables are on the host. With `--trace 1` the loop runs the mix's
`trace_requests` requests under `torch.profiler` instead, and the result
carries the per-layer metrics, the device's busy and window seconds and
the breakdown. Either way a seeded sample of the finished clips is then
compared with the plain reference (`compare.py`), and each number compared
is printed beside its limit: on standard error, and under "checks", last in
the result line, which is the last line on standard output.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

from ofc_bench import clips as clipgen  # noqa: E402
from ofc_bench import compare, spec, trace  # noqa: E402
from ofc_bench.entries import ENTRIES, Done  # noqa: E402

# Top-level module names the process must not hold once the window has
# closed: JAX and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "opticalflowclustering_tpu")


class Reservoir:
    """A uniform sample of `k` finished clips, drawn from the seed as they
    finish; the tables of a clip that leaves the sample are let go."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.kept = k, rng, 0, []

    def offer(self, done: Done) -> None:
        if not done.ok:
            return
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(done)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.kept[j].load = None
            self.kept[j] = done
        else:
            done.load = None


def _sync(torch, device: str) -> None:
    if device.startswith("cuda"):
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def _submit(entry, clip: int) -> list[Done]:
    try:
        return entry.submit(clip)
    except Exception:  # noqa: BLE001 — a failed request is counted, and the loop goes on
        traceback.print_exc()
        now = time.time()
        return [Done(c, now, now, entry.pairs, False, dict) for c in entry.request_clips(clip)]


def closed_loop(entry, n_clips: int, seconds: float, sample: Reservoir):
    """Requests in turn until `seconds` have passed since the first; the
    window closes when the last request has returned."""
    done: list[Done] = []
    t0 = time.time()
    i = 0
    while time.time() - t0 < seconds:
        for d in _submit(entry, i % n_clips):
            done.append(d)
            sample.offer(d)
        i += 1
    return done, t0, time.time()


def traced_loop(torch, entry, n_clips: int, requests: int, sample: Reservoir, device: str, workdir: str):
    """`requests` requests under torch.profiler, in one span of their own;
    returns what finished and the Chrome trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    done: list[Done] = []
    with profile(activities=activities) as prof:
        with record_function(trace.WINDOW):
            for i in range(requests):
                with record_function(trace.REQUEST):
                    for d in _submit(entry, i % n_clips):
                        done.append(d)
                        sample.offer(d)
            _sync(torch, device)
    path = f"{workdir}/trace.json"
    prof.export_chrome_trace(path)
    with open(path) as f:
        return done, json.load(f)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None) -> dict:
    """One run of `cell` on `device` (cuda, or cpu for a rehearsal): the
    result line as a dict, "checks" last."""
    import torch

    t_start = T_START if t_start is None else t_start
    cuda = device.startswith("cuda")
    chips = cell.chips if cuda else 0
    traffic, config = cell.traffic, cell.config
    reference = importlib.import_module(f"ofc_bench.reference.{config['reference']}")
    with tempfile.TemporaryDirectory(prefix="ofc_bench-") as workdir:
        t_imports = time.time()
        clip_list = clipgen.make_clips(config, traffic, seed)
        t_clips = time.time()
        entry = ENTRIES[traffic["entry"]](config, traffic, clip_list, workdir, device)
        n_clips = len(clip_list)
        t_entry = time.time()
        entry.warm()
        _sync(torch, device)
        setup_s = time.time() - t_start
        print(f"set-up {setup_s:.3f} s: imports {t_imports - t_start:.3f}, clips {t_clips - t_imports:.3f}, "
              f"files and entry {t_entry - t_clips:.3f}, warm request {t_start + setup_s - t_entry:.3f}",
              file=sys.stderr)

        sample = Reservoir(int(traffic["sample"]), clipgen.rng_for(seed, 1))
        metrics: dict[str, dict] = {}
        device_info: dict = {}
        breakdown = None
        if traced:
            for i in range(chips):
                torch.cuda.reset_peak_memory_stats(i)
            done, chrome = traced_loop(torch, entry, n_clips, int(traffic["trace_requests"]), sample, device,
                                       workdir)
            pairs = sum(d.pairs for d in done if d.ok)
            peak = max((torch.cuda.max_memory_allocated(i) for i in range(chips)), default=None)
            view = trace.TraceView(chrome, pairs=pairs, config=config, devices=list(range(chips)),
                                   peak_alloc_bytes=peak,
                                   clip_ms=[(d.finished - d.submitted) * 1e3 for d in done if d.ok])
            del chrome
            for m in cell.per_layer:
                value = spec.metric_reader(m["name"], cell.base)(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            device_info = {"busy_s": view.busy_s() if chips else 0.0, "window_s": view.window_s}
            breakdown = view.breakdown()
            del view
        else:
            done, t0, t1 = closed_loop(entry, n_clips, seconds, sample)
            ok = [d for d in done if d.ok]
            pairs = sum(d.pairs for d in ok)
            values = {
                "pairs_per_s": pairs / (t1 - t0),
                "pair_ms": (t1 - t0) * 1e3 / pairs if pairs else float("inf"),
                "clip_p90_ms": float(np.percentile([(d.finished - d.submitted) * 1e3 for d in ok], 90))
                if ok else float("inf"),
                "setup_s": setup_s,
            }
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        peak_bytes = max((torch.cuda.max_memory_allocated(i) for i in range(chips)), default=0)
        attempted, failed = len(done), sum(1 for d in done if not d.ok)

        # The check: the program's tables of each sampled clip against the
        # reference's, run now that the window has closed and the peak is read.
        got = [(d.clip, d.load()) for d in sample.kept]
        del done, sample
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.time()
        want = {clip: reference.clip_tables(entry.reference_input(clip), config, device,
                                            emit_flow_bgr=config["emit_flow_bgr"])
                for clip in sorted({c for c, _ in got})}
        checked = compare.checks(compare.compare([(g, want[c]) for c, g in got]), config["limits"])
        print(f"clips compared: {len(got)} of {attempted - failed} finished, in {time.time() - t_check:.3f} s",
              file=sys.stderr)

    result = {
        "correct": bool(got) and failed == 0 and compare.passed(checked),
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips,
            "memory_peak_bytes": peak_bytes,
            **device_info,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checked
    return result


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    held = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if held:
        print(f"the process holds {held} after the window: nothing of JAX or the JAX package may load",
              file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    for name, c in result["checks"].items():  # the numbers compared, beside their limits
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
