"""The dp×sp paths across several cards: a check, not a benchmark.

    python -m opticalflowclustering_tpu_torch.scripts.multicard_check --device cuda
    python -m opticalflowclustering_tpu_torch.scripts.multicard_check --device cpu --size 64 96 --spatial-size 336 128

On `cuda` it needs four cards; on `cpu` it names the CPU four times and uses
gloo. On four 17-frame clips (`scripts/clips.synth_frames`, written as MJPG,
so cv2 is needed) it checks that:

  1. `processqueue --dp 2 --sp 2` over the four devices writes the same
     artifacts as the sequential `processqueue` (integer tables bitwise,
     mean_magnitude within rtol 1e-6), in two successful batches;
  2. `sharded_hue_pipeline_videos` on a 2×2 mesh of the four devices equals
     `unsharded_hue_pipeline_videos` on the first;
  3. two processes, two devices each (`CUDA_VISIBLE_DEVICES`), joined by
     `multihost.initialize` (NCCL on cuda, gloo on cpu), pass an
     `all_reduce`, build the global 2×2 mesh, and run
     `process_video_queue_dp` on their own rows, each writing its
     round-robin share with artifacts equal to the sequential queue's;
  4. the row-sharded flow across cards (at --spatial-size, default 720×1280,
     with the reference's Farneback call): `spatial_farneback_flow_padded`
     on a tp=4 mesh of the four devices within 5e-5 px of (in fact bitwise
     equal to) the unsharded flow of the padded frames on the first, and
     `spatial_hue_pipeline` on a tp=2 mesh of two of them, its tables
     bitwise the unsharded pipeline's.

It prints the kernel launches of each run and ends with "multicard check:
ok"; any failed check raises, so the exit code is non-zero.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
KEYS = ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def check_same(a: dict, b: dict, tag: str) -> None:
    for k in KEYS[:3]:
        check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), f"{tag} {k}: not equal")
    np.testing.assert_allclose(a["mean_magnitude"], b["mean_magnitude"], rtol=1e-6, err_msg=tag)


def check_artifacts(paths, out_dir: str, seq_dir: str) -> None:
    from opticalflowclustering_tpu_torch.pipeline import queue as q

    for p in paths:
        stem = os.path.splitext(os.path.basename(p))[0] + ".features.npz"
        check_same(q.load_features(os.path.join(out_dir, stem)),
                   q.load_features(os.path.join(seq_dir, stem)), p)


def worker(device: str, rank: int, port: str, clips_dir: str, out_dir: str, seq_dir: str) -> None:
    """One of the two processes of check 3."""
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.parallel import multihost
    from opticalflowclustering_tpu_torch.pipeline import queue as q
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig

    if device == "cpu":
        torch.set_num_threads(1)  # two processes share the host's cores
    multihost.initialize(f"localhost:{port}", 2, rank, device=device)
    x = torch.tensor([float(rank + 1)], device="cuda" if device == "cuda" else "cpu")
    torch.distributed.all_reduce(x)
    check(float(x) == 3.0, f"all_reduce gave {float(x)}")
    mesh = multihost.global_mesh(sp=2, local_devices=None if device == "cuda" else ["cpu", "cpu"])
    check(mesh.shape == {"dp": 2, "sp": 2} and mesh.owners.tolist() == [[0, 0], [1, 1]], f"{mesh}")
    paths = sorted(os.path.join(clips_dir, f) for f in os.listdir(clips_dir))
    cfg = PipelineConfig(emit_flow_bgr=False, flow=FarnebackParams(warp_mode="fast"))
    kw.reset_launches()
    res = q.process_video_queue_dp(paths, out_dir, mesh, cfg)
    mine = multihost.host_shard(paths)
    check(sorted(r.video for r in res) == mine and all(r.ok for r in res), f"results {res}")
    check(q.LAST_DP_STATS["batches"] >= 1 and q.LAST_DP_STATS["batch_failures"] == 0, f"{q.LAST_DP_STATS}")
    check_artifacts(mine, out_dir, seq_dir)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: {len(mine)} videos on its own row, artifacts = sequential queue's; "
          f"launches {kw.LAUNCHES}, stats {q.LAST_DP_STATS}", flush=True)


def run_processes(device: str, clips_dir: str, out_dir: str, seq_dir: str) -> None:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
        if device == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = ("0,1", "2,3")[rank]
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "opticalflowclustering_tpu_torch.scripts.multicard_check", "--device", device,
             "--worker", str(rank), str(port), clips_dir, out_dir, seq_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        lines = [ln for ln in out.splitlines() if " INFO " not in ln]
        print("\n".join(f"  [rank {rank}] {ln}" for ln in lines[-12:]))
        check(p.returncode == 0, f"rank {rank} exited {p.returncode}")


def spatial_check(devs, h: int, w: int) -> None:
    """Check 4: the row-sharded flow and hue pipeline across the devices."""
    from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
    from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow, pyramid_plan
    from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.ops.colorspace import bgr2gray
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.parallel.spatial import spatial_farneback_flow_padded, spatial_hue_pipeline
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    params, grid = FarnebackParams(), GridParams()
    gray = bgr2gray(torch.from_numpy(synth_frames(3, h, w)).to(devs[0]))
    prev, nxt = gray[:-1], gray[1:]
    kw.reset_launches()
    flow = spatial_farneback_flow_padded(prev, nxt, make_mesh({"tp": 4}, devs), "tp", params)
    launches = dict(kw.LAUNCHES)
    pad = (-h) % (4 * 2**params.levels)

    def padded(g):
        return torch.cat([g, g[:, -1:].expand(g.shape[0], pad, w)], dim=1)

    want = farneback_flow(padded(prev), padded(nxt), params)[:, :h]
    diff = float((flow - want).abs().max())
    check(tuple(flow.shape) == (2, h, w, 2) and diff <= 5e-5, f"spatial flow tp=4: max |Δ| {diff} px")
    # one box_solve launch per block, level and iteration on the card; the CPU runs the plain version
    runs = 4 * len(pyramid_plan(h + pad, w, params)) * params.iterations if devs[0].type == "cuda" else 0
    check(launches == {"warp_m": 0, "box_solve": runs, "gauss_solve": 0}, f"spatial flow launches {launches}, expected {runs}")
    got = spatial_hue_pipeline(prev, nxt, make_mesh({"tp": 2}, devs[:2]), "tp", grid, params)
    f = farneback_flow(prev, nxt, params)
    bgr = render_flow_hsv_bgr(f)
    cen, hue = dominant_hue_k1_frames(bgr, grid)
    for name, a, b in (("hue", got[0], hue), ("rgb_hue", got[1], grid_mean_hue(bgr, grid)), ("centroids", got[2], cen)):
        check(torch.equal(a.cpu(), b.cpu()), f"spatial hue pipeline {name}: not equal")
    print(f"4. spatial_farneback_flow_padded 2 pairs {w}x{h} on a tp=4 mesh of {[str(d) for d in devs]}: max |Δ| "
          f"{diff:.3g} px from the unsharded flow on {devs[0]}, launches {launches}; spatial_hue_pipeline on "
          f"{[str(d) for d in devs[:2]]}: tables equal to the unsharded pipeline's")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--size", type=int, nargs=2, default=(720, 1280), metavar=("H", "W"))
    ap.add_argument("--spatial-size", type=int, nargs=2, default=(720, 1280), metavar=("H", "W"),
                    help="frame size of check 4 (its tp=4 blocks must clear the flow's halo)")
    ap.add_argument("--worker", nargs=5, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        rank, port, clips_dir, out_dir, seq_dir = args.worker
        worker(args.device, int(rank), port, clips_dir, out_dir, seq_dir)
        return 0

    from opticalflowclustering_tpu_torch.cli import processqueue
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.io.video import write_video_mjpg
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.parallel.mesh import cuda_devices, make_mesh
    from opticalflowclustering_tpu_torch.parallel.temporal import (
        sharded_hue_pipeline_videos,
        unsharded_hue_pipeline_videos,
    )
    from opticalflowclustering_tpu_torch.pipeline import queue as q
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames
    from opticalflowclustering_tpu_torch.utils.profiling import card_line

    if args.device == "cuda":
        devs = cuda_devices()
        check(len(devs) >= 4, f"four cards needed, {len(devs)} visible")
        devs = devs[:4]
        for i in range(4):
            print(f"card {i}: {card_line(i)}")
    else:
        devs = [torch.device("cpu")] * 4
    h, w = args.size
    frames = synth_frames(41, h, w)
    with tempfile.TemporaryDirectory(prefix="ofc-multicard-") as tmp:
        clips_dir = os.path.join(tmp, "clips")
        os.makedirs(clips_dir)
        for i in range(4):
            write_video_mjpg(os.path.join(clips_dir, f"clip{i}.avi"), frames[i * 8 : i * 8 + 17], 30.0)
        paths = sorted(os.path.join(clips_dir, f) for f in os.listdir(clips_dir))
        seq_dir, dp_dir = os.path.join(tmp, "seq"), os.path.join(tmp, "dp")

        check(processqueue.main([*paths, "-o", seq_dir, "--device", args.device]) == 0, "sequential CLI")
        kw.reset_launches()
        check(processqueue.main([*paths, "-o", dp_dir, "--dp", "2", "--sp", "2", "--device", args.device]) == 0,
              "dp CLI")
        check(q.LAST_DP_STATS["batches"] == 2 and q.LAST_DP_STATS["batch_failures"] == 0, f"{q.LAST_DP_STATS}")
        check_artifacts(paths, dp_dir, seq_dir)
        print(f"1. processqueue --dp 2 --sp 2 over {[str(d) for d in devs]}: artifacts = sequential queue's; "
              f"launches {kw.LAUNCHES}, stats {q.LAST_DP_STATS}")

        mesh = make_mesh({"dp": 2, "sp": 2}, devs)
        videos = np.stack([frames[:16], frames[16:32]])
        params = FarnebackParams(warp_mode="fast")
        kw.reset_launches()
        got = sharded_hue_pipeline_videos(videos, mesh, grid=GridParams(), params=params)
        launches = dict(kw.LAUNCHES)
        want = unsharded_hue_pipeline_videos(videos, GridParams(), params, device=devs[0])
        check_same(dict(zip(KEYS, (t.numpy() for t in got))), dict(zip(KEYS, (t.cpu().numpy() for t in want))),
                   "temporal")
        print(f"2. sharded_hue_pipeline_videos {list(videos.shape)} on a 2x2 mesh of {[str(d) for d in devs]} "
              f"= unsharded; launches {launches}")

        run_processes(args.device, clips_dir, os.path.join(tmp, "procs"), seq_dir)
        print(f"3. two processes ({'NCCL' if args.device == 'cuda' else 'gloo'}), two devices each: "
              "all_reduce, global mesh, each its share of the dp queue = sequential queue's")
    spatial_check(devs, *args.spatial_size)
    print("multicard check: ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
