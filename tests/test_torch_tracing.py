"""The port's pipeline spans (`utils/profiling.span`), on the CPU under
torch.profiler: each entry the benchmark drives (`process_frames`,
`process_video_stream`, `process_video_queue_dp`) opens its stages' spans on
the caller's thread, the spans nest, no two of one name overlap, the flow
opens one pyramid and one poly-expansion span per level and image, the
outputs are bitwise those of an untraced run, no span is made while no
profiler runs, and `trace_to` also holds the decode threads' spans."""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, pyramid_plan
from opticalflowclustering_tpu_torch.io.video import write_video_mjpg
from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
from opticalflowclustering_tpu_torch.pipeline.bounce import (
    OverlaySpec,
    PipelineConfig,
    process_frames,
    process_video_stream,
)
from opticalflowclustering_tpu_torch.pipeline.queue import load_features, process_video_queue_dp
from opticalflowclustering_tpu_torch.utils import profiling

torch.set_num_threads(1)

H, W, FRAMES, CHUNK = 64, 96, 9, 4  # 8 pairs: two chunks; two pyramid levels
CFG = PipelineConfig(flow=FarnebackParams(warp_mode="fast"), chunk=CHUNK)
LEVELS = len(pyramid_plan(H, W, CFG.flow))

FLOW = {"ofc.flow.pyramid", "ofc.flow.poly", "ofc.flow.solve"}
STAGES = FLOW | {"ofc.stack", "ofc.upload", "ofc.render", "ofc.grid", "ofc.readback"}
# entry → (the spans it opens on the caller's thread, farneback_flow calls)
ENTRIES = {
    "frames": (STAGES | {"ofc.process_frames"}, 2),
    "frames_overlay": (STAGES | {"ofc.process_frames", "ofc.overlay"}, 2),
    "stream": (STAGES | {"ofc.process_video_stream", "ofc.decode.wait"}, 2),
    # the native decoder's wait span opens only where a frame is not decoded yet
    "stream_native": (STAGES | {"ofc.process_video_stream"}, 2),
    # 2 videos on a 2 × 2 mesh: one batch of four blocks
    "queue": (STAGES | {"ofc.process_video_queue_dp", "ofc.decode.wait", "ofc.halo", "ofc.save"}, 4),
}


def _clip(seed: int) -> np.ndarray:
    """A textured frame drifting a pixel a frame, so the flow has work."""
    base = np.random.default_rng(seed).integers(0, 256, (H + FRAMES, W + FRAMES, 3), dtype=np.uint8)
    return np.stack([base[i : i + H, i : i + W] for i in range(FRAMES)])


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tracing")
    clips = [_clip(1), _clip(2)]
    paths = []
    for i, c in enumerate(clips):
        paths.append(str(d / f"clip{i}.avi"))
        write_video_mjpg(paths[-1], c, 25.0)
    yolo = d / "yolo.txt"
    yolo.write_text("2 0 0 10 8 30 20 0 0 0 0\n3 0 0 40 30 20 10 0 0 0 0\n")
    return {"dir": d, "clips": clips, "paths": paths, "yolo": str(yolo), "runs": 0}


def _run(entry: str, inputs) -> dict[str, np.ndarray]:
    """One request of `entry` on the CPU: its tables, by key."""
    if entry == "frames":
        return process_frames(inputs["clips"][0], CFG, "cpu")
    if entry == "frames_overlay":
        return process_frames(inputs["clips"][0], CFG, "cpu", overlays=OverlaySpec(yolo_file=inputs["yolo"]))
    if entry in ("stream", "stream_native"):
        return process_video_stream(inputs["paths"][0], CFG, None, entry == "stream_native", device="cpu")
    out_dir = inputs["dir"] / f"artifacts{inputs['runs']}"
    inputs["runs"] += 1
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    results = process_video_queue_dp(inputs["paths"], str(out_dir), mesh, CFG, resume=False)
    assert [r.ok for r in results] == [True, True]
    return {f"{i}.{k}": v for i, r in enumerate(sorted(results, key=lambda r: r.video))
            for k, v in load_features(r.path).items()}


def _spans(chrome: dict) -> list[dict]:
    return [e for e in chrome["traceEvents"] if e.get("ph") == "X" and e["name"].startswith("ofc.")]


@pytest.fixture(scope="module", params=list(ENTRIES))
def traced(request, inputs, tmp_path_factory):
    """(entry, untraced tables, traced tables, the trace's `ofc.*` spans, the
    caller's thread id as the trace gives it)."""
    entry = request.param
    plain = _run(entry, inputs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tables = _run(entry, inputs)
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    spans = _spans(json.loads(path.read_text()))
    (root,) = [e for e in spans if e["name"].startswith("ofc.process_")]
    return entry, plain, tables, spans, root["tid"]


def test_entry_opens_its_stage_spans_on_the_callers_thread(traced):
    entry, _, _, spans, tid = traced
    want, _ = ENTRIES[entry]
    assert tid == threading.get_native_id()
    names = {e["name"] for e in spans}
    assert names == want or (entry == "stream_native" and names == want | {"ofc.decode.wait"})
    assert {e["tid"] for e in spans} == {tid}  # the decode threads' spans are not in this profile


def test_spans_nest_and_no_two_of_one_name_overlap(traced):
    _, _, _, spans, _ = traced
    ivs = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans), key=lambda s: (s[0], -s[1]))
    (root,) = [s for s in ivs if s[2].startswith("ofc.process_")]
    assert ivs[0] == root and all(root[0] <= a and b <= root[1] for a, b, _ in ivs)
    open_: list[tuple] = []
    for a, b, name in ivs:
        while open_ and open_[-1][1] <= a:
            open_.pop()
        assert not open_ or b <= open_[-1][1], f"{name} [{a}, {b}] crosses {open_[-1]}"
        assert name not in {n for _, _, n in open_}, f"{name} opens inside another {name}"
        open_.append((a, b, name))


def test_flow_opens_a_pyramid_and_a_poly_span_per_level_and_image(traced):
    entry, _, _, spans, _ = traced
    _, flows = ENTRIES[entry]
    for name, per_flow in (("ofc.flow.pyramid", 2 * LEVELS), ("ofc.flow.poly", 2 * LEVELS),
                           ("ofc.flow.solve", LEVELS)):
        assert sum(e["name"] == name for e in spans) == flows * per_flow, name


def test_outputs_under_the_profiler_are_bitwise_the_untraced_ones(traced):
    _, plain, tables, _, _ = traced
    assert plain.keys() == tables.keys()
    for k in plain:
        assert plain[k].dtype == tables[k].dtype and np.array_equal(plain[k], tables[k]), k


@pytest.mark.parametrize("entry", ["frames", "stream", "queue"])
def test_no_profiler_no_record_function(entry, inputs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("ofc.a") is profiling.span("ofc.b")  # one shared nullcontext
    _run(entry, inputs)


@pytest.mark.parametrize("entry", ["stream", "queue"])
def test_trace_to_holds_the_decode_threads_spans(entry, inputs, tmp_path):
    with profiling.trace_to(str(tmp_path)):
        _run(entry, inputs)
    spans = _spans(json.loads((tmp_path / "trace.json").read_text()))
    (root,) = [e for e in spans if e["name"].startswith("ofc.process_")]
    decode = [e for e in spans if e["name"] == "ofc.decode"]
    # the prefetch thread's: one per batch (two chunks) and the end of the
    # file; the queue's decode thread's: one per video
    assert len(decode) == {"stream": 3, "queue": 2}[entry]
    assert root["tid"] not in {e["tid"] for e in decode}
    assert "ofc.decode.wait" in {e["name"] for e in spans if e["tid"] == root["tid"]}
