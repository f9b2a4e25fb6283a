"""The port stands apart from JAX: no source of the port imports jax or the
JAX package (read with ast), importing and running its main path and its
probe path loads neither jax nor cv2 nor pandas, its video decode equals the
JAX package's and loads no module of it, the state it carries
across from the JAX package (configs, constant tables) equals the original
(opticalflowclustering_tpu_torch.convert ↔ the JAX modules that build the
tables), the native decoder needs no codec library, and chip_smoke.py's
phases run end to end on the CPU with the kernel entries replaced by counted
plain versions."""

import ast
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow import farneback as jfb
from opticalflowclustering_tpu.ops.colorspace import _hsv_div_tables
from opticalflowclustering_tpu.ops.filters import gaussian_kernel
from opticalflowclustering_tpu.ops.resize import _linear_weight_matrix
from opticalflowclustering_tpu.pipeline.bounce import PipelineConfig as JPipe
from opticalflowclustering_tpu_torch import convert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch.pipeline import bounce
from opticalflowclustering_tpu_torch.cli import kmeangrids
from opticalflowclustering_tpu_torch.kernels import warp
from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.compat import writers
rng = np.random.default_rng(0)
frames = rng.integers(0, 256, (3, 64, 100, 3), dtype=np.uint8)
cfg = bounce.PipelineConfig(chunk=2, flow=bounce.FarnebackParams(warp_mode="fast"))
out = bounce.process_frames(frames, cfg, device="cpu")
assert out["hue_table"].shape == (2, 350), out["hue_table"].shape
bad = [m for m in ("jax", "jaxlib", "cv2", "pandas") if m in sys.modules]
print("LOADED", bad)
"""


def test_port_imports_no_jax_cv2_or_pandas():
    """In a fresh interpreter: import the port's pipeline, CLI, kernels,
    convert and writers modules and run process_frames on the CPU; jax,
    cv2 and pandas stay unloaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


_PROBE_PATH = """
import sys
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch.kernels import probes
from opticalflowclustering_tpu_torch.utils import profiling
from opticalflowclustering_tpu_torch.scripts import clips, gather_cost_probe, profile_r4
x, idx = gather_cost_probe.tile("cpu")
for body in probes.BODIES:
    xb = x.to(torch.bfloat16) if body == "take_bf16" else x
    assert probes.loop_probe(body, xb, idx, 5).shape == (80, 128)
off = torch.tensor([1], dtype=torch.int32)
assert torch.equal(probes.dynslice(x.to(torch.bfloat16), off), x.to(torch.bfloat16)[8:32].float())
assert clips.synth_frames(2, 36, 64).shape == (2, 36, 64, 3)
t = profiling.StageTimer()
with t.stage("probe", sync=x):
    pass
bad = [m for m in ("jax", "jaxlib", "cv2", "pandas") if m in sys.modules]
print("LOADED", bad)
"""


def test_probe_modules_import_no_jax_or_cv2():
    """In a fresh interpreter: import the probe kernels, the profiling
    utilities and the probe scripts, and run every plain probe on the CPU;
    jax, cv2 and pandas stay unloaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _PROBE_PATH],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


def _port_sources():
    port = os.path.join(REPO, "opticalflowclustering_tpu_torch")
    for root, _, files in os.walk(port):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(root, name)
    yield os.path.join(REPO, "chip_smoke.py")


def _foreign_imports(path):
    """(line, module) of every import in `path` of jax, jaxlib, flax, optax,
    pandas or the JAX package (opticalflowclustering_tpu but not ..._torch),
    at any depth."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax", "pandas", "opticalflowclustering_tpu"):
                found.append((node.lineno, name))
    return found


def test_port_sources_import_nothing_of_jax(tmp_path):
    """Read, not run: every .py of the port and chip_smoke.py, walked with
    ast, imports neither jax, jaxlib, flax, optax, pandas nor anything of the
    JAX package, also inside functions, where an import-and-run probe does
    not reach."""
    sources = list(_port_sources())
    assert len(sources) > 30
    port = os.path.join(REPO, "opticalflowclustering_tpu_torch")
    for rel in ("io/video.py", "pipeline/queue.py", "parallel/mesh.py", "parallel/temporal.py",
                "parallel/multihost.py", "cli/computeopticalflow.py", "cli/findcosine.py",
                "cli/processqueue.py", "utils/logging.py", "cluster/kmeans.py", "ops/lab.py",
                "extras/quantize.py", "extras/nms.py", "io/images.py", "cli/colorkmeans.py",
                "models/flow_cnn.py", "models/cnn.py", "models/bounce_classifier.py", "models/layers.py",
                "cli/classify.py", "cli/detect.py", "cli/realtime.py", "cli/trainbounce.py",
                "parallel/train.py", "convert.py", "cli/drawgrids.py",
                "cli/vectordistance.py", "ops/morphology.py", "extras/contours.py", "io/overlays.py",
                "ops/threshold.py", "ops/edges.py", "ops/hough.py", "cli/detectcircles.py", "ops/ssim.py",
                "ops/slic.py", "cli/superpixels.py", "ops/histogram.py", "ops/moments.py", "ops/warp.py",
                "parallel/spatial.py", "graft_entry.py", "extras/cluster_viz.py", "extras/compare_images.py",
                "extras/histograms.py", "extras/compare_histograms.py", "extras/color_transfer.py",
                "extras/search_engine.py", "extras/detectors.py", "extras/document_scanner.py", "extras/pokedex.py",
                "cli/scan.py", "cli/searchengine.py", "io/fastio.py"):
        assert os.path.join(port, rel) in sources, rel
    bad = {os.path.relpath(p, REPO): f for p in sources if (f := _foreign_imports(p))}
    assert bad == {}
    # The walk finds imports nested in functions, and tells the port's own
    # package from the JAX package.
    probe = tmp_path / "probe.py"
    probe.write_text(
        "import opticalflowclustering_tpu_torch.io.video\n"
        "def f():\n"
        "    from opticalflowclustering_tpu.io.video import read_video_bgr\n"
        "    import jax.numpy, jaxlib\n"
        "    from flax import linen\n"
        "    import optax, pandas as pd\n"
    )
    assert _foreign_imports(str(probe)) == [
        (3, "opticalflowclustering_tpu.io.video"), (4, "jax.numpy"), (4, "jaxlib"), (5, "flax"),
        (6, "optax"), (6, "pandas")]


def test_read_video_bgr_equals_the_jax_packages():
    """The port's io.video.read_video_bgr ↔ the JAX package's (cv2 path) on
    the demo clip: array_equal, whole and cut to max_frames."""
    from opticalflowclustering_tpu.io import video as jvideo
    from opticalflowclustering_tpu_torch.io import video as tvideo

    demo = os.path.join(REPO, "demo_out", "601_3.avi")
    whole = tvideo.read_video_bgr(demo)
    np.testing.assert_array_equal(whole, jvideo.read_video_bgr(demo))
    assert whole.dtype == np.uint8 and whole.shape[1:] == (232, 220, 3)
    np.testing.assert_array_equal(tvideo.read_video_bgr(demo, 4), whole[:4])
    assert tvideo.is_lfs_pointer(demo) is False
    with pytest.raises(FileNotFoundError):
        tvideo.read_video_bgr(os.path.join(REPO, "demo_out", "no_such.avi"))


_VIDEO_PROBE = """
import sys
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch.pipeline import bounce
cfg = bounce.PipelineConfig(chunk=2, flow=bounce.FarnebackParams(warp_mode="fast"))
out = bounce.process_video_file("demo_out/601_3.avi", cfg, max_frames=3, device="cpu")
assert out["hue_table"].shape == (2, 350), out["hue_table"].shape
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "opticalflowclustering_tpu")]
print("LOADED", bad)
"""


def test_process_video_file_loads_no_jax_package_module():
    """In a fresh interpreter: process_video_file decodes the demo clip with
    the port's own io.video and runs it on the CPU; no module of jax, jaxlib
    or the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _VIDEO_PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


def test_chip_smoke_probe_phase_rehearsal(monkeypatch, capsys):
    """chip_smoke.probe_phase on the CPU at small sizes: the kernel entries
    are counted plain versions, the card timers (CUDA events and the CUDA
    graph's replay) a host-clocked loop and the SM clock a fixed 1980 MHz.
    Every check of the phase runs, at every trip count mod probes.UNROLL,
    each probe kernel and warp kernel is counted on the probe path, every
    body's three bounds and dynslice's launch floor are printed, and the
    phase returns the two probe entries of the results line with every field
    the contract names."""
    import chip_smoke
    from opticalflowclustering_tpu_torch.kernels import probes
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.scripts import gather_cost_probe as gcp
    from opticalflowclustering_tpu_torch.scripts import profile_r4 as pr4
    from opticalflowclustering_tpu_torch.utils import profiling

    def counted(mod, name, plain):
        def run(*args):
            mod.LAUNCHES[name] += 1
            return plain(*args)

        monkeypatch.setattr(mod, name, run)

    def host_ms(fn, repeats=10, warmup=1):
        for _ in range(warmup):
            fn()
        best = math.inf
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    counted(probes, "loop_probe", probes.loop_probe_reference)
    counted(probes, "dynslice", probes.dynslice_reference)
    counted(kw, "warp_m", kw.warp_m_reference)
    counted(kw, "box_solve", kw.box_solve_reference)
    def host_graph_ms(fn, launches=200, repeats=10):
        return host_ms(lambda: [fn() for _ in range(launches)], repeats) / launches

    monkeypatch.setattr(profiling, "event_ms", host_ms)
    monkeypatch.setattr(profiling, "graph_ms", host_graph_ms)
    monkeypatch.setattr(profiling, "sm_clocks_mhz", lambda index=0: (1755.0, 1980.0))
    monkeypatch.setattr(gcp, "GRAPH_LAUNCHES", 4)
    monkeypatch.setattr(gcp, "N_LO", 8)
    monkeypatch.setattr(gcp, "N_HI", 64)
    for name, value in [("N_LO", 8), ("N_HI", 64), ("BW_SHAPE", (4, 72, 128)), ("H", 64),
                        ("W", 100), ("FRAMES", 3), ("REPEATS", 1), ("WARP_BATCH", 2)]:
        monkeypatch.setattr(pr4, name, value)
    torch.set_num_threads(1)

    entries = chip_smoke.probe_phase(torch.device("cpu"), "[cpu rehearsal]")
    out = capsys.readouterr().out
    assert out.count("bitwise equal to the plain version") == len(probes.BODIES) + 1
    for tag in ("mul:", "where:", "take:", "take-bf16:", "bf16 8-row", "A. ", "B. ",
                "D. fast/smooth", "D. fast16/noise", "C. smooth", "C. measured", "launch floor",
                "host-inclusive", "time dynslice: kernel"):
        assert tag in out, tag
    assert {n % probes.UNROLL for n in chip_smoke.PROBE_CHECK_N} == set(range(probes.UNROLL))
    assert f"n={chip_smoke.PROBE_CHECK_N}" in out
    for body in probes.BODIES:
        line = next(ln for ln in out.splitlines() if ln.startswith(f"time loop_probe {body} "))
        assert "ALU" in line and "acc chain" in line and "shared memory" in line and "1980 MHz" in line
        assert (f"bank conflicts loop_probe {body}:" in out) == (probes.STAGED_ROWS[body] > 0)
    assert probes.LAUNCHES["loop_probe"] > 0 and probes.LAUNCHES["dynslice"] > 0
    assert kw.LAUNCHES["warp_m"] > 0 and kw.LAUNCHES["box_solve"] > 0
    assert [e["name"] for e in entries] == ["loop_probe", "dynslice"]
    for e in entries:
        assert {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
                "plain_ms", "bound_ms", "bound_by", "library_ms"} <= set(e)
        assert e["bound_ms"] > 0 and e["bound_by"] in ("bytes", "operations")
        assert e["route"] == "cuda" and os.path.isfile(os.path.join(REPO, e["source"]))
        assert e["launches"] == probes.LAUNCHES[e["name"]] and e["max_abs_err"] == 0.0
        for ref in e["replaces"].split(", "):
            path, line = ref.split(":")
            with open(os.path.join(REPO, path)) as f:
                assert "def " in f.read().splitlines()[int(line) - 1], ref
        assert e["design"]
    bodies = entries[0]["bodies"]
    assert sorted(bodies) == sorted(probes.BODIES)
    assert all(b["ns_per_iter"] > 0 and b["plain_ns_per_iter"] > 0 and b["bound_ns_per_iter"] > 0
               for b in bodies.values())
    for b in bodies.values():
        assert b["bound_ns_per_iter"] == max(b["alu_bound_ns"], b["chain_bound_ns"], b["smem_bound_ns"])
    assert bodies["take"]["busiest_row_wavefronts"] == 17 and bodies["mul"]["busiest_row_wavefronts"] == 0
    assert entries[1]["launch_floor_ms"] > 0 and entries[1]["host_ms"] > 0
    json.dumps(entries)


def test_from_jax_config_round_trip():
    """Every field of the JAX PipelineConfig / FarnebackParams / GridParams
    arrives in the port's config of the same name (warp_radius too, and
    'select' with it); a warp mode the port lacks raises."""
    jcfg = JPipe(
        grid=JGrid(rows=10, cols=12),
        flow=jfb.FarnebackParams(
            pyr_scale=0.6, levels=4, winsize=13, iterations=2, poly_n=7,
            poly_sigma=1.5, gaussian_win=True, warp_mode="fast16", warp_radius=16,
        ),
        rb_swap=False,
        chunk=5,
        emit_flow_bgr=False,
    )
    tcfg = convert.from_jax_config(jcfg)
    for obj_j, obj_t in ((jcfg, tcfg), (jcfg.flow, tcfg.flow), (jcfg.grid, tcfg.grid)):
        assert type(obj_t).__name__ == type(obj_j).__name__
        for f in dataclasses.fields(obj_t):
            if f.name not in ("grid", "flow"):
                assert getattr(obj_t, f.name) == getattr(obj_j, f.name), f.name
    assert convert.from_jax_config(JPipe()) == type(tcfg)()
    assert tcfg.flow.warp_radius == 16
    sel = convert.from_jax_config(jfb.FarnebackParams(warp_mode="select", warp_radius=8))
    assert (sel.warp_mode, sel.warp_radius) == ("select", 8)
    with pytest.raises(ValueError, match="bogus"):
        convert.from_jax_config(jfb.FarnebackParams(warp_mode="bogus"))
    with pytest.raises(TypeError):
        convert.from_jax_config(object())


@pytest.mark.parametrize("hw", [(720, 1280), (144, 200), (75, 131)])
def test_constant_tables_equal_the_jax_originals(hw):
    """Each table of convert.constant_tables is array_equal to what the JAX
    function of its key builds for the same config and frame size."""
    h, w = hw
    jp = jfb.FarnebackParams()
    tables = convert.constant_tables(convert.from_jax_config(JPipe()), h, w)
    g, xg, xxg, *inv = jfb._poly_exp_consts(jp.poly_n, jp.poly_sigma)
    sdiv, hdiv = _hsv_div_tables()
    want = {
        "poly_exp_consts.g": g,
        "poly_exp_consts.xg": xg,
        "poly_exp_consts.xxg": xxg,
        "poly_exp_consts.inv_gram": np.array(inv),
        "border_scale": jfb._BORDER_SCALE,
        "pyramid_plan": np.array(jfb.pyramid_plan(h, w, jp)),
        "hsv_div_tables.sdiv": sdiv,
        "hsv_div_tables.hdiv": hdiv,
    }
    prev = None
    for k, h_k, w_k, sigma in jfb.pyramid_plan(h, w, jp):
        smooth_sz = max(jfb._cvround(sigma * 5) | 1, 3)
        want[f"gaussian_kernel.level{k}"] = gaussian_kernel(smooth_sz, sigma)
        want[f"linear_weight_matrix.level{k}.h"] = _linear_weight_matrix(h_k, h)
        want[f"linear_weight_matrix.level{k}.w"] = _linear_weight_matrix(w_k, w)
        if prev is not None:
            want[f"linear_weight_matrix.flow{k}.h"] = _linear_weight_matrix(h_k, prev[0])
            want[f"linear_weight_matrix.flow{k}.w"] = _linear_weight_matrix(w_k, prev[1])
        want[f"border_taper.level{k}"] = jfb._border_taper(h_k, w_k)
        prev = (h_k, w_k)
    assert sorted(tables) == sorted(want)
    for key, table in tables.items():
        assert table.dtype == want[key].dtype, key
        np.testing.assert_array_equal(table, want[key], err_msg=key)


_VIDEO_PATH_PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch.cli import computeopticalflow, findcosine, processqueue
from opticalflowclustering_tpu_torch.io import video
from opticalflowclustering_tpu_torch.parallel import mesh, multihost, temporal
from opticalflowclustering_tpu_torch.pipeline import bounce, queue
from opticalflowclustering_tpu_torch.utils import logging
frames = np.random.default_rng(0).integers(0, 256, (1, 4, 64, 64, 3), dtype=np.uint8)
m = mesh.make_mesh({"dp": 1, "sp": 2}, ["cpu"] * 2)
grid = bounce.GridParams(rows=2, cols=2)
params = bounce.FarnebackParams(levels=1, warp_mode="fast")
hue = temporal.sharded_hue_pipeline_videos(frames, m, grid=grid, params=params)[0]
assert tuple(hue.shape) == (1, 4, 4), hue.shape
cfg = bounce.PipelineConfig(grid=grid, flow=params, chunk=2)
out = bounce._stream_tables(video.prefetch_chunks(iter(frames[0]), 2), cfg, torch.device("cpu"))
assert out["hue_table"].shape == (3, 4)
from opticalflowclustering_tpu_torch.cli import drawgrids, vectordistance
from opticalflowclustering_tpu_torch.features import grid as fgrid
cen, hue, rgb = bounce.grid_cluster_stage(frames[0], grid, True, "cpu")
cells = fgrid.whiten_grid_lines(fgrid.extract_cells(torch.from_numpy(frames[0]), grid), grid, True)
assert hue.shape == (4, 4) and cells.shape == (4, 4, 32, 32, 3)
bad = [m for m in ("jax", "jaxlib", "cv2", "pandas") if m in sys.modules]
print("LOADED", bad)
"""


def test_video_path_modules_import_no_jax_cv2_or_pandas():
    """In a fresh interpreter: import the video-file paths' modules (the
    stream, the queue, parallel, the CLIs computeopticalflow, findcosine, processqueue, drawgrids and
    vectordistance, logging), run the temporal split, the stream's device
    loop on frames from memory, the grid/cluster stage and the cell tensor
    on the CPU; jax, cv2 and pandas stay unloaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _VIDEO_PATH_PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


_SURFACE_PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch import graft_entry, parallel
from opticalflowclustering_tpu_torch.cli import scan, searchengine
from opticalflowclustering_tpu_torch.extras import (cluster_viz, color_transfer, compare_histograms, compare_images,
                                                    detectors, document_scanner, histograms, pokedex, search_engine)
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
rng = np.random.default_rng(0)
prev = rng.integers(0, 256, (80, 64), dtype=np.uint8)
mesh = parallel.make_mesh({"tp": 2}, ["cpu"] * 2)
flow = parallel.spatial_farneback_flow(prev, np.roll(prev, 1, 0), mesh, params=FarnebackParams(levels=1, warp_radius=8))
assert tuple(flow.shape) == (80, 64, 2)
img = rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)
assert search_engine.index_images(img[None], device="cpu").shape == (1, 512)
assert color_transfer.color_transfer(img, img[::-1], device="cpu").shape == (40, 60, 3)
assert len(detectors.detect_colors(img, device="cpu")) == 4
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "cv2", "pandas", "opticalflowclustering_tpu")]
print("LOADED", bad)
"""


def test_spatial_entry_and_extras_modules_import_no_jax_or_cv2():
    """In a fresh interpreter: import the spatial flow, the dryrun entry,
    the nine extras and the scan and searchengine CLIs, and run the spatial
    flow, a batched index and two extras on the CPU; no module of jax, cv2,
    pandas or the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _SURFACE_PROBE], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


def _rehearse_on_cpu(monkeypatch):
    """chip_smoke's new phases on the CPU: the kernel entries are counted
    plain versions (the poly expansion's and the pyramid's taken on CPU
    tensors too, as on the card), "cuda" resolves to the CPU, one timing
    repeat, and the cv2 demo check reads 5 frames."""
    import types

    import chip_smoke
    from opticalflowclustering_tpu_torch import runtime
    from opticalflowclustering_tpu_torch.flow import farneback
    from opticalflowclustering_tpu_torch.kernels import poly as kp
    from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.pipeline import bounce

    for mod, name, plain in ((kw, "warp_m", kw.warp_m_reference), (kw, "box_solve", kw.box_solve_reference),
                             (kp, "poly_expansion", kp.poly_expansion_reference),
                             (kpyr, "pyramid", kpyr.pyramid_reference)):
        def run(*args, mod=mod, name=name, plain=plain):
            mod.LAUNCHES[name] += 1
            return plain(*args)

        monkeypatch.setattr(mod, "pyramid_level" if mod is kpyr else name, run)
    monkeypatch.setattr(farneback, "poly_kernel_takes", lambda img, n: n <= farneback.MAX_KERNEL_POLY_N)
    card = types.SimpleNamespace(device=torch.device("cuda"))
    takes = farneback.pyramid_kernel_takes
    monkeypatch.setattr(farneback, "pyramid_kernel_takes", lambda img, *args: takes(card, *args))
    real = runtime.resolve_device

    def to_cpu(name):
        return real("cpu" if torch.device(name).type == "cuda" else name)

    monkeypatch.setattr(runtime, "resolve_device", to_cpu)
    monkeypatch.setattr(bounce, "resolve_device", to_cpu)
    monkeypatch.setattr(chip_smoke, "REPEATS", 1)
    monkeypatch.setattr(chip_smoke, "DEMO_FRAMES", 5)
    torch.set_num_threads(1)
    return chip_smoke, bounce, kw


def test_chip_smoke_stream_and_findcosine_phases_rehearsal(monkeypatch, capsys):
    """chip_smoke.stream_phase and findcosine_phase on a 7-frame 288×512
    clip at chunk 4 (two chunks, the second zero-padded): the stream's
    launches are the 2 chunks × 4 levels × 3 iterations the check expects,
    its tables equal process_frames', the cv2 branch streams the demo clip,
    both paths are timed, and findcosine (asked for cuda) finds the planted
    window."""
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, bounce, kw = _rehearse_on_cpu(monkeypatch)
    dev = torch.device("cpu")
    frames = synth_frames(7, 288, 512)
    cfg = bounce.PipelineConfig(chunk=4, flow=bounce.FarnebackParams(warp_mode="fast"))
    want = bounce.process_frames(frames, cfg, dev)
    launches = chip_smoke.stream_phase(dev, "[cpu rehearsal]", frames, want, cfg)
    assert launches == {"warp_m": 24, "box_solve": 24, "gauss_solve": 0, "poly_expansion": 16,
                        "pyramid": 16}  # 2 chunks x 4 levels x 2 images
    series = want["hue_table"].astype(np.float32).mean(axis=1)
    chip_smoke.findcosine_phase(series, 2, 3)
    out = capsys.readouterr().out
    for tag in ("stream 7x288x512 through the prefetch thread", "601_3.avi (5 frames, cv2 decode thread)",
                "time process_frames 7x288x512", "time stream 7x288x512", "findcosine --device cuda"):
        assert tag in out, tag


def test_chip_smoke_queue_and_temporal_phases_rehearsal_without_cv2(monkeypatch, capsys):
    """chip_smoke.queue_phase and temporal_phase as on a machine without
    cv2: the queue's decoder is the in-memory stand-in (and is put back
    after), three 3-frame 288×512 clips give one dp batch and one
    leftover with the launches the design implies (queue 3 × 12, dp queue
    4 blocks × 12 + 12), and the 2×2 temporal split equals the unsharded
    pipeline."""
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, bounce, kw = _rehearse_on_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "have_cv2", lambda: False)
    real_read = io_video.read_video_bgr
    dev = torch.device("cpu")
    cfg = bounce.PipelineConfig(chunk=4, flow=bounce.FarnebackParams(warp_mode="fast"))
    clips = [synth_frames(3, 288, 512, seed=s) for s in range(3)]
    launches = chip_smoke.queue_phase(dev, "[cpu rehearsal]", clips, cfg)
    assert io_video.read_video_bgr is real_read
    assert launches == {"queue": {"warp_m": 36, "box_solve": 36, "gauss_solve": 0, "poly_expansion": 24, "pyramid": 24},
                        "dp_queue": {"warp_m": 60, "box_solve": 60, "gauss_solve": 0, "poly_expansion": 40,
                                     "pyramid": 40}}
    videos = np.stack([synth_frames(2, 288, 512, seed=s) for s in (4, 5)])
    launches = chip_smoke.temporal_phase(dev, videos, cfg)
    assert launches == {"temporal": {"warp_m": 48, "box_solve": 48, "gauss_solve": 0, "poly_expansion": 32, "pyramid": 32},
                        "temporal_unsharded": {"warp_m": 12, "box_solve": 12, "gauss_solve": 0, "poly_expansion": 8,
                                               "pyramid": 8}}
    out = capsys.readouterr().out
    for tag in ("dp queue on a 2x2 mesh of cpu", "'batches': 1", "decode from memory",
                "time process_video_queue 3 videos", "time process_video_queue_dp 3 videos",
                "temporal [2, 2, 288, 512, 3] on a 2x2 mesh"):
        assert tag in out, tag


_MODEL_PATH_PROBE = """
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.cli import classify, colorkmeans, detect, realtime, trainbounce
from opticalflowclustering_tpu_torch.cluster import kmeans
from opticalflowclustering_tpu_torch.extras import nms, quantize
from opticalflowclustering_tpu_torch.io import images
from opticalflowclustering_tpu_torch.models import bounce_classifier, cnn, flow_cnn
from opticalflowclustering_tpu_torch.parallel import mesh, train
rng = np.random.default_rng(0)
img = torch.from_numpy(rng.integers(0, 256, (20, 30, 3), dtype=np.uint8))
assert quantize.quantize_colors(img, 3).shape == (20, 30, 3)
model = flow_cnn.load_params(device="cpu")
assert flow_cnn.classify_cells(model, rng.integers(0, 256, (2, 50, 50, 3), dtype=np.uint8)).shape == (2, 2)
assert len(convert.to_flax_params(model)) == 16
clf = bounce_classifier.init_classifier(None, 24, device="cpu")
step = train.make_fused_train_step(mesh.make_mesh({"dp": 1, "sp": 2}, ["cpu"] * 2), clf,
                                   bounce_classifier.adamw(clf.parameters(), 1e-3),
                                   flow_params=train.FarnebackParams(levels=1))
loss = step(rng.integers(0, 256, (1, 2, 32, 48, 3), dtype=np.uint8), np.zeros((1, 2), np.float32))
assert np.isfinite(float(loss))
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cv2", "pandas",
                                                     "opticalflowclustering_tpu")]
print("LOADED", bad)
"""


def test_model_path_modules_import_no_jax_cv2_or_pandas():
    """In a fresh interpreter: import the clustering and model modules and
    their five CLIs, quantize an image, classify with the committed weights
    and take one fused train step on a 1×2 CPU mesh; no module of jax,
    flax, optax, cv2, pandas or the JAX package is loaded."""
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-c", _MODEL_PATH_PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "LOADED []" in r.stdout, r.stdout


def test_chip_smoke_model_phases_rehearsal(monkeypatch, capsys):
    """chip_smoke.model_phases on the CPU at small sizes: "cuda" resolves to
    the CPU in every module that resolves a device, the kernel entries are
    counted plain versions, one timing repeat, 3 realtime frames. Flow
    frames rendered from a 4-frame 288×512 clip feed k-means (3 × 350
    cells of 20×20), colorkmeans, serving and quantize; a 48-value hue
    series feeds trainbounce; [2, 4, 96, 128, 3] videos feed the fused
    train step, whose launches are the design count on each mesh and
    which are the only kernel launches of the phases."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan
    from opticalflowclustering_tpu_torch.models import bounce_classifier, cnn, flow_cnn
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, bounce, kw = _rehearse_on_cpu(monkeypatch)
    for mod in (flow_cnn, cnn, bounce_classifier):
        monkeypatch.setattr(mod, "resolve_device", bounce.resolve_device)
    monkeypatch.setattr(chip_smoke, "REALTIME_FRAMES", 3)
    dev = torch.device("cpu")
    flow_bgr = bounce.process_frames(synth_frames(4, 288, 512), bounce.PipelineConfig(), dev)["flow_bgr"]
    series = np.random.default_rng(0).integers(0, 180, 48).astype(np.float32)
    videos = np.stack([synth_frames(4, 96, 128, seed=s) for s in (1, 2)])
    launches = chip_smoke.model_phases(dev, "[cpu rehearsal]", flow_bgr, series, videos)
    levels = len(pyramid_plan(96, 128, bounce.FarnebackParams()))
    per_flow = levels * 3
    zero = {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 0, "pyramid": 0}
    assert launches == {
        "kmeans": zero, "quantize": zero, "colorkmeans": zero, "serving": zero, "smallcnn": zero,
        "trainbounce": zero,
        "fused_train_2x2": {"warp_m": 12 * per_flow, "box_solve": 12 * per_flow, "gauss_solve": 0,
                            "poly_expansion": 12 * 2 * levels, "pyramid": 12 * 2 * levels},
        "fused_train_1x1": {"warp_m": 3 * per_flow, "box_solve": 3 * per_flow, "gauss_solve": 0,
                            "poly_expansion": 3 * 2 * levels, "pyramid": 3 * 2 * levels},
    }
    out = capsys.readouterr().out
    for tag in ("kmeans_batched k=3 n_iter=30 over 1050 cells x 400 px", "time kmeans_batched 1050 cells",
                "quantize_colors 128x96 k=8 method=lloyd", "method=minibatch",
                "colorkmeans -d (1050 PNG cells 20x20) -c 1 --device cuda: CSV byte-equal",
                "-c 3 --device cuda: ", "detect_windows 3 frames of 512x288, 190 windows each",
                "time FlowCellNet windows", "classify --device cuda: [INFO] classification took",
                "detect -c 0.5 --device cuda", "realtime -s demo_out/601_3.avi --max-frames 3",
                "SmallCNN 224x224 blob, 1000 classes", "trainbounce --steps 300 --device cuda: dataset: 24 windows (7 positive)",
                "fused train step [2, 4, 96, 128, 3]", "time fused train step 2x2", "time fused train step 1x1"):
        assert tag in out, tag


def test_chip_smoke_surface_phases_rehearsal(monkeypatch, capsys):
    """chip_smoke.surface_phases on the CPU: "cuda" resolves to the CPU in
    the pipeline and in every CLI, the kernel entries are counted plain
    versions, one timing repeat, a 5-frame 144×256 clip. EPE against cv2
    passes its gates with the design's levels × 3 iterations launches of
    each kernel per clip in fast and fast16; drawgrids matches
    itself at --max-frames 3 and dumps 4 × 350 cells, which the cell-tree
    path clusters to grid_cluster_stage's table; vectordistance agrees
    across devices; the grid CLIs launch no kernel."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, bounce, kw = _rehearse_on_cpu(monkeypatch)
    dev = torch.device("cpu")
    frames = synth_frames(5, 144, 256)
    series = np.random.default_rng(0).integers(0, 180, 48).astype(np.float32)
    rgb_series = np.random.default_rng(1).integers(0, 180, 40).astype(np.float32)
    launches = chip_smoke.surface_phases(dev, "[cpu rehearsal]", frames, series, rgb_series)
    out = capsys.readouterr().out
    zero = {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 0, "pyramid": 0}
    levels = len(pyramid_plan(144, 256, bounce.FarnebackParams())) + len(pyramid_plan(232, 220, bounce.FarnebackParams()))
    epe = 2 * 3 * levels  # fast and fast16 on both clips
    assert launches["epe"] == {"warp_m": epe, "box_solve": epe, "gauss_solve": 0, "poly_expansion": 3 * 2 * levels,
                               "pyramid": 3 * 2 * levels}  # and exact
    drawgrids_levels = 2 * len(pyramid_plan(144, 256, bounce.FarnebackParams()))
    drawgrids = {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": drawgrids_levels,
                 "pyramid": drawgrids_levels}
    assert {k: launches[k] for k in ("drawgrids", "celltree", "vectordistance")} == {
        "drawgrids": drawgrids, "celltree": zero, "vectordistance": zero}
    assert set(launches) == {"epe", "drawgrids", "celltree", "vectordistance"}
    for tag in ("4 pairs of synthetic 256x144", "4 pairs of demo_out/601_3.avi",
                "1400 cell PNGs; rgb_values rows equal to the CPU run's at --max-frames 3 (2 rows)",
                "kmeangrids cell-tree path (LFS stub --path) --device cuda: OutCSV/clip.csv: 4 frames x 350 cells",
                "hue table bitwise equal to grid_cluster_stage's",
                "vectordistance --device cuda on 32 and 40 hues: Cosine similarity: "):
        assert tag in out, tag




def test_chip_smoke_surface_phases_fail_on_a_wrong_epe_launch_count(monkeypatch):
    """chip_smoke.surface_phases holds the EPE phase's launches against the
    design's count and stops there: with the design off by one, the phase
    fails before drawgrids runs."""
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, _, _ = _rehearse_on_cpu(monkeypatch)
    runs = chip_smoke.kernel_runs
    monkeypatch.setattr(chip_smoke, "kernel_runs", lambda *a: runs(*a) + 1)
    monkeypatch.setattr(chip_smoke, "drawgrids_phase", lambda *a: pytest.fail("ran past the EPE check"))
    series = np.zeros(8, np.float32)
    with pytest.raises(AssertionError, match="epe: expected"):
        chip_smoke.surface_phases(torch.device("cpu"), "[cpu]", synth_frames(5, 144, 256), series, series)


def test_chip_smoke_overlay_and_ops_phases_rehearsal(monkeypatch, capsys):
    """chip_smoke.overlay_ops_phases on the CPU: "cuda" resolves to the CPU
    in the pipeline and in every CLI, the kernel entries are counted plain
    versions, the card timer is a host clock, one timing repeat, a 5-frame
    288×512 clip and Hough/SLIC compared at 144×256. kmeangrids with its
    default flags draws the written boxes and polygons and launches the
    design's 4 levels × 3 iterations of each kernel; its table equals
    grid_cluster_stage over the host-drawn overlays; the ops agree across
    "devices" and their CLIs run; the ops launch no kernel."""
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames
    from opticalflowclustering_tpu_torch.utils import profiling

    def host_ms(fn, repeats=10, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    chip_smoke, _, _ = _rehearse_on_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "OPS_CMP_HW", (144, 256))
    monkeypatch.setattr(profiling, "event_ms", host_ms)
    launches = chip_smoke.overlay_ops_phases(torch.device("cpu"), "[cpu rehearsal]", synth_frames(5, 288, 512))
    assert launches == {"overlay": {"warp_m": 12, "box_solve": 12, "gauss_solve": 0, "poly_expansion": 8, "pyramid": 8},
                        "ops": {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 0, "pyramid": 0}}
    out = capsys.readouterr().out
    for tag in ("overlay: kmeangrids with its default flags (overlays on) --device cuda on 5 frames 512x288 with 2 "
                "boxes and ", "OutCSV/clip.csv: 4 frames x 350 cells", "table bitwise equal to grid_cluster_stage",
                "byte-equal to the host drawing", "time overlay path (flow_bgr returned) 5x288x512",
                "time feature-only process_frames 5x288x512",
                "ops 512x288: canny, morphology, calc_hist, warp_perspective bitwise equal card vs CPU",
                "the same circles card vs CPU at 256x144", "slic labels equal card vs CPU at 256x144: 1.000000",
                "detectcircles --device cuda: ", "superpixels --device cuda: superpixels_100.png: ",
                "time ops on the card, 512x288", "hough_circles cv2-raw circles"):
        assert tag in out, tag


def test_chip_smoke_spatial_dryrun_extras_phases_rehearsal(monkeypatch, capsys):
    """chip_smoke.spatial_dryrun_extras_phases on the CPU: "cuda" resolves to
    the CPU in every module that resolves a device, the kernel entries are
    counted plain versions, the card timer is a host clock, one timing
    repeat, 5 frames of 336×128 (the smallest clip whose tp=4 blocks clear
    the halo; 336 rows pad to 352 on tp=4). The spatial runs launch
    box_solve blocks × levels × iterations times and warp_m never, the
    dryrun's passes launch the design's kernels (pass 1.75 both), entry()
    (its 720p frames cut to 144×256) none, the extras none; every check of
    the phases runs."""
    from opticalflowclustering_tpu_torch import graft_entry
    from opticalflowclustering_tpu_torch.parallel import spatial
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames
    from opticalflowclustering_tpu_torch.utils import profiling

    def host_ms(fn, repeats=10, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    chip_smoke, bounce, _ = _rehearse_on_cpu(monkeypatch)
    for mod in (spatial, graft_entry):
        monkeypatch.setattr(mod, "resolve_device", bounce.resolve_device)
    monkeypatch.setattr(profiling, "event_ms", host_ms)
    entry = graft_entry.entry

    def small_entry(device):  # entry()'s 720p frames, cut to 144x256
        fn, (frames,) = entry(device)
        return fn, (frames[:, :144, :256],)

    monkeypatch.setattr(graft_entry, "entry", small_entry)
    launches = chip_smoke.spatial_dryrun_extras_phases(torch.device("cpu"), "[cpu rehearsal]",
                                                       synth_frames(5, 336, 128))
    # 2 blocks x 3 levels at 336x128: box_solve x 3 iterations, the poly expansion x 2 images; the
    # blocks blur with the plain blur, so the pyramid kernel runs only in unsharded flows
    box = {"warp_m": 0, "box_solve": 2 * 3 * 3, "gauss_solve": 0, "poly_expansion": 2 * 3 * 2, "pyramid": 0}
    zero = {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 0, "pyramid": 0}
    # levels=1 is 2 pyramid levels: 4 blocks x 2 levels x 2 images, and the unsharded flow's 4
    tp4 = {"warp_m": 0, "box_solve": 24, "gauss_solve": 0, "poly_expansion": 20, "pyramid": 4}
    assert launches == {
        "spatial_hue_tp2": box, "spatial_flow_tp2": box,
        "spatial_padded_tp4": {"warp_m": 0, "box_solve": 36, "gauss_solve": 0, "poly_expansion": 24, "pyramid": 0},
        "dryrun_1": {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 20, "pyramid": 20},
        "dryrun_1.5": tp4, "dryrun_1.6": tp4, "dryrun_1.7": tp4,
        "dryrun_1.75": {"warp_m": 45, "box_solve": 45, "gauss_solve": 0, "poly_expansion": 30, "pyramid": 30},
        "dryrun_2": {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 16, "pyramid": 16},
        "entry": {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 6, "pyramid": 6}, "extras": zero}
    out = capsys.readouterr().out
    for tag in ("check box_solve at the M-region shapes of the tp=2 and tp=4 blocks: bitwise",
                "spatial 4 pairs 128x336, FarnebackParams() (3 levels): spatial_hue_pipeline on a tp=2 mesh of cpu: "
                "tables bitwise equal", "padded tp=4 (352 rows)", "time spatial, 4 pairs 128x336, ms per pair",
                "check warp_m (max abs err 0) and box_solve (bitwise) at the 512x128 'fast' level shapes "
                "[2,5,128,32] [2,5,256,64] [2,5,512,128] [8,5,128,32]",
                "dryrun_multichip: near-flagship geometry ok (bitwise)", "dryrun_multichip(4) on a mesh of cpu x4: "
                "six passes ok", "entry() forward, 5 frames 256x144, exact flow: tables equal to process_frames'",
                "scan: wrote cuda_warped.png cuda_binarized.png", "searchengine: index of 32 and search -k 5",
                "color_transfer: 0 of ", "skin_mask, locate_barcode (box", "find_screen: a ",
                "time extras on the card, 128x336"):
        assert tag in out, tag


# What native/fastio.cpp may include: C++ standard headers and two POSIX ones.
_NATIVE_HEADERS = {"sys/stat.h", "pthread.h", "algorithm", "atomic", "cstddef", "cstdint", "cstdio", "cstdlib",
                   "cstring", "map", "mutex", "string", "thread", "utility", "vector"}


def test_native_decoder_needs_no_codec_library():
    """native/fastio.cpp includes only C++ standard headers and <sys/stat.h>
    / <pthread.h> (no jpeglib.h, png.h, zlib.h), its build command links no
    library, and the library it builds depends on no libjpeg, libpng or
    libz."""
    from opticalflowclustering_tpu_torch.io import fastio

    src = fastio.SRC.read_text()
    includes = [line.split("<", 1)[1].split(">", 1)[0] for line in src.splitlines()
                if line.startswith("#include")]
    assert includes and set(includes) <= _NATIVE_HEADERS, includes
    assert '#include "' not in src
    cmd = fastio.build_command("out.so")
    assert cmd[0] == "g++" and not [a for a in cmd if a.startswith("-l")], cmd
    deps = subprocess.run(["ldd", str(fastio._build())], capture_output=True, text=True, timeout=60).stdout
    assert "libstdc++" in deps
    assert not any(lib in deps for lib in ("libjpeg", "libturbojpeg", "libpng", "libz")), deps


def test_chip_smoke_native_decode_phase_rehearsal(monkeypatch, capsys):
    """chip_smoke.native_decode_phase on the CPU on a 7-frame 288×512 clip at
    chunk 4: the decoder builds, the clip and the demo clip decode the same
    at 1 thread and at every core, the demo clip to its pinned digest,
    the native stream's launches are 2 chunks × 4 levels × 3 iterations, all
    its 6 pairs came through the native decoder (none through cv2), and
    both decoders and both streams are timed; then the clip re-encoded
    baseline and progressive: the progressive clip decodes to the baseline
    clip's bytes, within 5 codes of cv2, and its native stream makes the
    same launches through the native decoder alone, with the baseline
    clip's tables; both decoders on both clips and both streams are timed;
    then the arithmetic-coded phase on 7-frame clips of two committed 48×64
    tiles in place of the 720p ones: the SOF9 and SOF10 demo clips decode to
    the demo clip's bytes, the SOF9 and SOF10 clips to the baseline clip's,
    and their native streams make 2 chunks × 1 level × 3 iterations
    launches through the native decoder alone, with the baseline clip's
    tables; the three clips are timed. The decoders are put back."""
    from opticalflowclustering_tpu_torch.io import fastio
    from opticalflowclustering_tpu_torch.io import video as io_video
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, bounce, _ = _rehearse_on_cpu(monkeypatch)
    monkeypatch.setattr(chip_smoke, "ARITH_TILES", ("420_q75", "420_dac_l2_u5_k2"))
    real = (fastio.stream_mjpeg_avi, io_video.stream_video_chunks)
    cfg = bounce.PipelineConfig(chunk=4, flow=bounce.FarnebackParams(warp_mode="fast"))
    launches = chip_smoke.native_decode_phase(torch.device("cpu"), "[cpu rehearsal]", synth_frames(7, 288, 512), cfg)
    runs = {"warp_m": 24, "box_solve": 24, "gauss_solve": 0, "poly_expansion": 16, "pyramid": 16}
    small = {"warp_m": 6, "box_solve": 6, "gauss_solve": 0, "poly_expansion": 4, "pyramid": 4}
    assert launches == {"native_stream": runs, "native_stream_progressive": runs, "native_stream_sof9": small,
                        "native_stream_sof10": small}
    assert (fastio.stream_mjpeg_avi, io_video.stream_video_chunks) == real
    out = capsys.readouterr().out
    for tag in ("native decoder: built with `g++ -O3 -shared -fPIC -std=c++17 -pthread",
                f"native decode demo_out/601_3.avi (75, 232, 220, 3): 1 and {os.cpu_count()} threads bitwise equal",
                f"sha256 {chip_smoke.DEMO_NATIVE_SHA256}", "7 frames through the native decoder, 0 through cv2",
                "time decode 512x288 clip (7 frames 512x288), frames/s: native",
                "time decode demo_out/601_3.avi (75 frames 220x232), frames/s: native",
                "time stream 7x288x512 native decode", "time stream 7x288x512 cv2 decode",
                f"progressive = baseline bitwise at 1 and {os.cpu_count()} threads",
                "native stream of the progressive clip 7x288x512 warp_mode=fast: launches "
                f"{runs} (design {runs}); 7 frames through the native decoder, 0 through cv2; "
                "tables bitwise equal to the baseline clip's native stream",
                "time decode re-encoded 512x288 clip (7 frames, quality 90 4:2:0), frames/s: progressive native",
                "progressive cv2 ", "time stream 7x288x512 native decode of the baseline clip",
                "time stream 7x288x512 native decode of the progressive clip",
                f"SOF9 and SOF10 ({chip_smoke.ARITH_GOLDEN}/demo_sof9.avi, demo_sof10.avi): bitwise the demo "
                f"clip's at 1 and {os.cpu_count()} threads",
                f"SOF9 = SOF10 = baseline bitwise at 1 and {os.cpu_count()} threads",
                f"native stream of the sof10 clip 7x48x64 warp_mode=fast: launches {small} "
                f"(design {small}); 7 frames through the native decoder, 0 through cv2; tables bitwise equal to the "
                "baseline clip's native stream",
                "time decode arithmetic 64x48 clip (7 frames), frames/s: sof9 native",
                "baseline native 1 thread", "time stream 7x48x64 native decode of the sof9 clip",
                "time stream 7x48x64 native decode of the baseline clip"):
        assert tag in out, tag


def test_chip_smoke_select_phase_rehearsal(monkeypatch, capsys):
    """chip_smoke.select_phase on the CPU on a 5-frame 144×256 clip: the
    'select' flow on both clips (the clip's first 4 pairs and demo_out
    frames 30-34) agrees across "devices", its EPE against exact and cv2 is
    printed, process_frames in 'select' and 'fast' are timed in turns, and
    no 'select' run launches a kernel."""
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, _, _ = _rehearse_on_cpu(monkeypatch)
    launches = chip_smoke.select_phase(torch.device("cpu"), "[cpu rehearsal]", synth_frames(5, 144, 256))
    # 1 flow x 3 levels x 2 images, no warp kernel
    poly = {"warp_m": 0, "box_solve": 0, "gauss_solve": 0, "poly_expansion": 6, "pyramid": 6}
    assert launches == {"select_flow_synthetic": poly, "select_flow_demo": poly, "select_process_frames": poly}
    out = capsys.readouterr().out
    for tag in ("select flow, 4 pairs of synthetic 256x144", "card vs CPU mean EPE 0 px (bound 0.001), bitwise True",
                "select flow, 4 pairs of demo_out/601_3.avi 220x232", "vs exact ", "vs cv2 ",
                "time process_frames 5x144x256 chunk 16, tables only, median of 1 in turns: select ",
                "peak allocated not measured (no card)", "; fast "):
        assert tag in out, tag


def test_chip_smoke_select_phase_fails_on_a_kernel_launch(monkeypatch):
    """chip_smoke.select_phase holds the 'select' path to no kernel launch:
    with farneback_flow routed through the kernel wrappers, it fails at its
    first flow."""
    from opticalflowclustering_tpu_torch.flow import farneback
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    chip_smoke, _, _ = _rehearse_on_cpu(monkeypatch)
    monkeypatch.setattr(farneback, "uses_kernels", lambda params: True)
    with pytest.raises(AssertionError, match="select flow synthetic 256x144 launched"):
        chip_smoke.select_phase(torch.device("cpu"), "[cpu]", synth_frames(5, 144, 256))
