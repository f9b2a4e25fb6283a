"""PyTorch port vs the JAX package: meshes, the temporal split and the
multi-process layer (opticalflowclustering_tpu_torch.parallel.mesh /
temporal / multihost ↔ opticalflowclustering_tpu.parallel.mesh / temporal /
multihost).

On the CPU a mesh names the CPU device several times, which lays the
dp×sp block structure (splits, halos, the wrapped junk pair) over one
device. The sharded pipeline's integer tables equal the unsharded one's and
its mean_magnitude is within rtol 1e-6 (measured: bitwise); the port's
unsharded pipeline is held against the JAX one un-jitted (the JAX sharded
tests are `slow` for their compile time): integer tables equal,
mean_magnitude within rtol 1e-5."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.parallel import mesh as jmesh
from opticalflowclustering_tpu.parallel import temporal as jtemporal
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.flow.farneback import farneback_flow
from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
from opticalflowclustering_tpu_torch.parallel import multihost, temporal
from opticalflowclustering_tpu_torch.parallel.mesh import Mesh, device_array, make_mesh

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JGRID = JGrid(rows=4, cols=4)
JPARAMS = JFlow(levels=1, warp_mode="fast")
GRID = from_jax_config(JGRID)
PARAMS = from_jax_config(JPARAMS)
INT = (0, 1, 2)  # hue, rgb_hue, centroids


def _videos(b=4, n=8, h=64, w=64, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(b, n, h, w, 3), dtype=np.uint8)


def _assert_tables(got, want, rtol, tag):
    assert len(got) == len(want) == 4, tag
    for i in INT:
        g, w = np.asarray(got[i]), np.asarray(want[i])
        assert g.dtype == w.dtype and np.array_equal(g, w), (tag, i)
    np.testing.assert_allclose(np.asarray(got[3]), np.asarray(want[3]), rtol=rtol, err_msg=tag)


def test_make_mesh_shapes_match_jax():
    """jmesh.make_mesh ↔ make_mesh over 8 devices: the default axis, a -1
    axis, surplus devices left out; errors for too few devices and two -1
    axes; with no devices it needs CUDA and raises here."""
    cpus = ["cpu"] * 8
    for axes in (None, {"dp": 2, "sp": 4}, {"dp": 2, "sp": -1}, {"dp": -1, "sp": 2}, {"dp": 3}):
        got = make_mesh(axes, cpus)
        want = jmesh.make_mesh(axes, jax.devices()[:8])
        assert got.shape == dict(want.shape), axes
        assert got.axis_names == tuple(want.axis_names)
        assert all(d == torch.device("cpu") for d in got.devices.flat)
    m = make_mesh({"dp": 2, "sp": 2}, device_array(["cpu", "meta", "cpu", "meta"]))
    assert [str(d) for d in m.axis_devices("sp", "dp").flat] == ["cpu", "cpu", "meta", "meta"]
    assert [str(d) for d in m.axis_devices("sp")] == ["cpu", "meta"]
    with pytest.raises(ValueError, match="needs 16 devices"):
        make_mesh({"dp": 4, "sp": 4}, cpus)
    with pytest.raises(ValueError, match="at most one"):
        make_mesh({"dp": -1, "sp": -1}, cpus)
    with pytest.raises(ValueError, match="3-d device array"):
        Mesh(np.empty((1, 1, 1), object), ("dp", "sp"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()


@pytest.mark.parametrize("shape", [(1, 4), (2, 2), (4, 1)])
def test_sharded_videos_equal_unsharded(shape):
    """sharded_hue_pipeline_videos on a dp×sp CPU mesh ↔
    unsharded_hue_pipeline_videos: [4, 8, 64, 64] videos, every row
    including the wrapped junk pair."""
    videos = _videos()
    mesh = make_mesh({"dp": shape[0], "sp": shape[1]}, ["cpu"] * 4)
    got = temporal.sharded_hue_pipeline_videos(videos, mesh, grid=GRID, params=PARAMS)
    want = temporal.unsharded_hue_pipeline_videos(videos, GRID, PARAMS, device="cpu")
    assert tuple(got[0].shape) == (4, 8, 16) and tuple(got[2].shape) == (4, 8, 16, 4)
    assert got[0].dtype == torch.uint8 and got[2].dtype == torch.int32
    _assert_tables(got, want, 1e-6, shape)
    with pytest.raises(ValueError, match="does not divide"):
        temporal.sharded_hue_pipeline_videos(videos[:3, :7], mesh, grid=GRID, params=PARAMS)


def test_unsharded_matches_jax():
    """jtemporal.unsharded_hue_pipeline_videos (un-jitted) ↔ the port's on
    [2, 4, 64, 64] videos."""
    videos = _videos(2, 4)
    want = jtemporal.unsharded_hue_pipeline_videos(videos, JGRID, JPARAMS)
    got = temporal.unsharded_hue_pipeline_videos(videos, GRID, PARAMS, device="cpu")
    _assert_tables(got, want, 1e-5, "port vs JAX")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            temporal.unsharded_hue_pipeline_videos(videos, GRID, PARAMS)


def test_temporal_shard_flow_and_single_video_pipeline():
    """temporal_shard_flow on a 4-way sp axis ↔ batched farneback_flow of
    consecutive pairs, with row N-1 the wrapped pair (frame N-1, frame 0);
    sharded_hue_pipeline ↔ the batch's first video of the unsharded one."""
    frames = _videos(1, 8)[0]
    mesh = make_mesh({"dp": 2, "sp": 4}, ["cpu"] * 8)
    got = temporal.temporal_shard_flow(frames, mesh, params=PARAMS)
    gray = bgr2gray(torch.from_numpy(frames))
    ring = torch.cat([gray, gray[:1]])
    want = farneback_flow(ring[:-1], ring[1:], PARAMS)
    assert got.shape == (8, 64, 64, 2) and torch.equal(got, want)
    hue, rgb_hue, mag = temporal.sharded_hue_pipeline(frames, mesh, grid=GRID, params=PARAMS)
    w = temporal.unsharded_hue_pipeline_videos(frames[None], GRID, PARAMS, device="cpu")
    _assert_tables((hue, rgb_hue, w[2][0], mag), [t[0] for t in w], 1e-6, "single video")


def test_host_shard_explicit_and_default():
    items = ["a", "b", "c", "d", "e"]
    assert multihost.host_shard(items, process_id=0, num_processes=2) == ["a", "c", "e"]
    assert multihost.host_shard(items, process_id=1, num_processes=2) == ["b", "d"]
    shards = [multihost.host_shard(items, i, 3) for i in range(3)]
    assert sorted(x for s in shards for x in s) == items
    assert multihost.host_shard(items) == items  # outside a process group
    assert (multihost.process_index(), multihost.process_count()) == (0, 1)


def test_global_mesh_and_local_submesh_single_process(monkeypatch):
    """global_mesh over 8 local entries → dp=4, sp=2, every row this
    process's, so local_submesh keeps all of it (as in JAX's single-process
    case); a row mixing processes raises; a process keeps only its rows."""
    mesh = multihost.global_mesh(sp=2, local_devices=["cpu"] * 8)
    assert mesh.shape == {"dp": 4, "sp": 2} and (mesh.owners == 0).all()
    sub = multihost.local_submesh(mesh)
    assert sub.shape == mesh.shape
    with pytest.raises(ValueError, match="not divisible"):
        multihost.global_mesh(sp=3, local_devices=["cpu"] * 8)
    two = Mesh(device_array(["cpu"] * 4).reshape(2, 2), ("dp", "sp"), np.array([[0, 0], [1, 1]]))
    monkeypatch.setattr(multihost, "process_index", lambda: 1)
    assert multihost.local_submesh(two).shape == {"dp": 1, "sp": 2}
    assert (multihost.local_submesh(two).owners == 1).all()
    mixed = Mesh(device_array(["cpu"] * 4).reshape(2, 2), ("dp", "sp"), np.array([[0, 1], [1, 1]]))
    with pytest.raises(ValueError, match="mix local and remote"):
        multihost.local_submesh(mixed)
    assert multihost.local_submesh(make_mesh({"dp": 2}, ["cpu"] * 2)).shape == {"dp": 2}


def test_initialize_arguments_and_env_fallbacks(monkeypatch):
    """initialize forwards explicit arguments, falls back to MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK, picks gloo on the CPU, and refuses
    incomplete settings and a CUDA device where there is none."""
    seen = []
    monkeypatch.setattr(multihost.dist, "init_process_group", lambda backend, **kw: seen.append((backend, kw)))
    multihost.initialize("localhost:1234", 2, 1, device="cpu")
    assert seen[-1][0] == "gloo"
    assert {k: seen[-1][1][k] for k in ("init_method", "world_size", "rank")} == {
        "init_method": "tcp://localhost:1234", "world_size": 2, "rank": 1}
    for k, v in {"MASTER_ADDR": "10.0.0.1", "MASTER_PORT": "29500", "WORLD_SIZE": "4", "RANK": "3"}.items():
        monkeypatch.setenv(k, v)
    multihost.initialize(device="cpu")
    assert {k: seen[-1][1][k] for k in ("init_method", "world_size", "rank")} == {
        "init_method": "tcp://10.0.0.1:29500", "world_size": 4, "rank": 3}
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="process"):
        multihost.initialize(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            multihost.initialize("localhost:1234", 2, 0)
    assert len(seen) == 2


_WORKER = r"""
import os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
pid, port, data_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3]

from opticalflowclustering_tpu_torch.features.grid import GridParams
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
from opticalflowclustering_tpu_torch.parallel import multihost
from opticalflowclustering_tpu_torch.pipeline import queue as q
from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig

multihost.initialize(f"localhost:{port}", 2, pid, device="cpu")
assert (multihost.process_index(), multihost.process_count()) == (pid, 2)

# 1. an all_reduce across both processes
x = torch.tensor([float(pid + 1)])
dist.all_reduce(x)
assert float(x) == 3.0, x

# 2. the global mesh: 2 processes x 4 local entries -> dp=4 (2 rows each), sp=2
mesh = multihost.global_mesh(sp=2, local_devices=["cpu"] * 4)
assert mesh.shape == {"dp": 4, "sp": 2}, mesh.shape
assert mesh.owners.tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]], mesh.owners
sub = multihost.local_submesh(mesh)
assert sub.shape == {"dp": 2, "sp": 2} and (sub.owners == pid).all()

# 3. the dp queue: each process takes its round-robin share and runs it on
# its own rows (3 same-shape clips at dp=2: one batch and one leftover)
cfg = PipelineConfig(grid=GridParams(rows=4, cols=4), flow=FarnebackParams(levels=1, warp_mode="fast"), chunk=4)
paths = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir) if f.endswith(".avi"))
assert len(paths) == 6
mine = multihost.host_shard(paths)
assert len(mine) == 3
out_dir = os.path.join(data_dir, "out")
res = q.process_video_queue_dp(paths, out_dir, mesh, cfg)
assert {r.video for r in res} == set(mine), (pid, [r.video for r in res])
assert all(r.ok for r in res), [(r.video, r.error) for r in res]
assert q.LAST_DP_STATS == {"peak_buffered_videos": 2, "batches": 1, "evictions": 0, "batch_failures": 0}, q.LAST_DP_STATS

seq_dir = os.path.join(data_dir, f"seq{pid}")
assert all(r.ok for r in q.process_video_queue(mine, seq_dir, cfg, device="cpu"))
for p in mine:
    stem = os.path.splitext(os.path.basename(p))[0]
    a = q.load_features(os.path.join(seq_dir, f"{stem}.features.npz"))
    b = q.load_features(os.path.join(out_dir, f"{stem}.features.npz"))
    for k in ("hue_table", "rgb_hue_table", "centroids"):
        assert np.array_equal(a[k], b[k]), (p, k)
    np.testing.assert_allclose(a["mean_magnitude"], b["mean_magnitude"], rtol=1e-6)
dist.barrier()
dist.destroy_process_group()
foreign = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "opticalflowclustering_tpu")]
assert not foreign, foreign
print(f"OK pid={pid} stats={q.LAST_DP_STATS}")
"""


def test_two_process_gloo_queue(tmp_path):
    """Two processes on gloo (tests/test_multihost.py's pattern):
    initialize, an all_reduce, the global mesh and its local submeshes, and
    process_video_queue_dp with shard_hosts, each process writing its
    round-robin share with artifacts equal to its sequential queue's. The
    workers import torch and the port only."""
    from opticalflowclustering_tpu.io.video import write_video_mjpg

    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(7)
    for i in range(6):
        write_video_mjpg(str(data_dir / f"clip{i}.avi"),
                         rng.integers(0, 256, size=(4, 48, 48, 3), dtype=np.uint8), 30.0)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO)
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        env.pop(k, None)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(pid), str(port), str(data_dir)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"pid {pid} failed:\n{out[-3000:]}"
        assert f"OK pid={pid}" in out
    assert len([f for f in os.listdir(data_dir / "out") if f.endswith(".npz")]) == 6


def test_multicard_check_script_on_cpu(capsys):
    """scripts/multicard_check.py --device cpu at 64×96: the dp CLI over four
    named devices equals the sequential CLI, the 2×2 temporal split equals
    the unsharded pipeline, its two gloo processes each write their share
    equal to the sequential queue's, and (at 336×128) the row-sharded flow
    on tp=4 equals the unsharded flow and the tp=2 hue pipeline its tables
    (the checks it runs on four cards with NCCL)."""
    from opticalflowclustering_tpu_torch.scripts import multicard_check

    assert multicard_check.main(["--device", "cpu", "--size", "64", "96", "--spatial-size", "336", "128"]) == 0
    out = capsys.readouterr().out
    for tag in ("1. processqueue --dp 2 --sp 2", "2. sharded_hue_pipeline_videos [2, 16, 64, 96, 3]",
                "[rank 0] rank 0: 2 videos", "[rank 1] rank 1: 2 videos", "3. two processes (gloo)",
                "4. spatial_farneback_flow_padded 2 pairs 128x336 on a tp=4 mesh", "max |Δ| 0 px",
                "multicard check: ok"):
        assert tag in out, tag
