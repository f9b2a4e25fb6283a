"""PyTorch port vs the JAX package: the legacy 'select' warp mode
(opticalflowclustering_tpu_torch.flow.farneback `_warp_select`,
`update_matrices(..., 'select', R)`, `farneback_flow` with
`FarnebackParams(warp_mode='select', warp_radius=R)` ↔ the JAX functions of
the same name), its pass-through in the pipelines, and the kmeangrids and
computeopticalflow CLIs with `--warp-mode select`.

The port's two clamped gathers reproduce JAX's where-chains bit for bit
when JAX runs un-jitted (`jax.disable_jit()`); against jitted JAX, where
XLA fuses the interpolation, M agrees within rtol 1e-4 / atol 1e-3.
'select' runs no kernel on any device, as in JAX, whose fused Pallas path
takes only 'fast' and 'fast16'."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from opticalflowclustering_tpu.flow import farneback as jfb
from opticalflowclustering_tpu_torch.flow import farneback as tfb
from opticalflowclustering_tpu_torch.kernels import warp as kw
from opticalflowclustering_tpu_torch.pipeline import bounce as tpl

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")
# Frames of the demo clip the CLI checks read: its first 8 frames are
# static (the committed 601_3.avi_opticalFlow.csv reads 0.0 up to frame 7),
# so 28 frames reach ~2 px of mean motion.
CLI_FRAMES = 28


def _cf(a):
    """[..., H, W, C] numpy → channel-first [..., C, H, W] tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _warp_inputs(case, radius, b=2, h=48, w=150, seed=0):
    """r1 [b, h, w, 5] and a flow [b, h, w, 2] whose displacements lie
    inside ±radius ('inside'), beyond it vertically ('beyond_y'), beyond it
    horizontally but within 126 ('beyond_x'), or point out of the image
    across every edge ('edges'); then the integer corners and fractions
    that `update_matrices` derives from the flow."""
    rng = np.random.default_rng(seed)
    r1 = rng.normal(0, 10, (b, h, w, 5)).astype(np.float32)
    if case == "inside":
        flow = rng.uniform(-radius + 1, radius - 1, (b, h, w, 2))
    elif case == "beyond_y":
        flow = np.stack([rng.uniform(-3, 3, (b, h, w)),
                         rng.choice([-1, 1], (b, h, w)) * rng.uniform(radius, 2 * radius + 10, (b, h, w))], -1)
    elif case == "beyond_x":
        flow = np.stack([rng.choice([-1, 1], (b, h, w)) * rng.uniform(radius, 126, (b, h, w)),
                         rng.uniform(-3, 3, (b, h, w))], -1)
    else:
        ys, xs = np.mgrid[0:h, 0:w]
        out = rng.uniform(0.2, radius + 5, (b, h, w))
        fx = np.where(xs < 6, -out, np.where(xs >= w - 6, out, rng.uniform(-2, 2, (b, h, w))))
        fy = np.where(ys < 6, -out, np.where(ys >= h - 6, out, rng.uniform(-2, 2, (b, h, w))))
        flow = np.stack([fx, fy], -1)
    flow = flow.astype(np.float32)
    gx = np.arange(w, dtype=np.float32)[None, :] + flow[..., 0]
    gy = np.arange(h, dtype=np.float32)[:, None] + flow[..., 1]
    x1, y1 = np.floor(gx), np.floor(gy)
    return r1, flow, y1.astype(np.int32), x1.astype(np.int32), gx - x1, gy - y1


@pytest.mark.parametrize("case", ["inside", "beyond_y", "beyond_x", "edges"])
@pytest.mark.parametrize("radius", [8, 32])
def test_warp_select_bitwise_vs_jax_eager(radius, case):
    """jfb._warp_select (un-jitted) ↔ tfb._warp_select: bitwise, at R = 8
    and 32, for displacements inside the radius, beyond it on either axis
    (the offsets clamp to ±R, columns at R too though the mask admits 126)
    and across every image edge (the edge pad). Against the jitted JAX
    function, where XLA fuses the interpolation, within atol 1e-5 on
    samples up to ~43 in size (measured 3.8e-6, a few float32 ulps)."""
    r1, _, y1i, x1i, fx, fy = _warp_inputs(case, radius)
    with jax.disable_jit():
        want = np.asarray(jfb._warp_select(jnp.asarray(r1), y1i, x1i, fx, fy, radius))
    jitted = np.asarray(jax.jit(jfb._warp_select, static_argnums=5)(jnp.asarray(r1), y1i, x1i, fx, fy, radius))
    got = tfb._warp_select(_cf(r1), *(torch.from_numpy(a) for a in (y1i, x1i, fx, fy)), radius)
    got = np.moveaxis(got.numpy(), -3, -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-5)


@pytest.mark.parametrize("radius", [8, 32])
def test_update_matrices_select_vs_jax(radius):
    """jfb.update_matrices(r0, r1, flow, 'select', R) ↔
    tfb.update_matrices(r0, r1, dx, dy, 'select', R): bitwise against eager
    JAX, within rtol 1e-4 / atol 1e-3 of jitted JAX, on a flow that mixes
    every case of `_warp_inputs` (so the reach mask |y1−y| ≤ R−1,
    |x1−x| ≤ 126 cuts some pixels to the out-of-bounds fallback)."""
    parts = [_warp_inputs(case, radius, b=1, seed=i) for i, case in enumerate(("inside", "beyond_y", "beyond_x",
                                                                               "edges"))]
    r1 = np.concatenate([p[0] for p in parts])
    flow = np.concatenate([p[1] for p in parts])
    r0 = np.random.default_rng(9).normal(0, 10, r1.shape).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jfb.update_matrices(r0, r1, flow, "select", radius))
    jitted = np.asarray(jax.jit(lambda a, b, c: jfb.update_matrices(a, b, c, "select", radius))(r0, r1, flow))
    dx, dy = (torch.from_numpy(np.ascontiguousarray(flow[..., i])) for i in (0, 1))
    got = np.moveaxis(tfb.update_matrices(_cf(r0), _cf(r1), dx, dy, "select", radius).numpy(), -3, -1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, jitted, rtol=1e-4, atol=1e-3)
    # the mask does cut: some pixels take the fallback that exact would not
    exact = np.moveaxis(tfb.update_matrices(_cf(r0), _cf(r1), dx, dy, "exact").numpy(), -3, -1)
    assert not np.array_equal(got, exact)


def _smooth(a, r=3):
    k = 2 * r + 1
    c = np.cumsum(np.pad(a, ((r + 1, r), (0, 0)), mode="edge"), axis=0)
    a = (c[k:] - c[:-k]) / k
    c = np.cumsum(np.pad(a, ((0, 0), (r + 1, r)), mode="edge"), axis=1)
    return (c[:, k:] - c[:, :-k]) / k


def test_select_gap_at_a_motion_discontinuity_matches_jax():
    """A 64×96 pair whose left half moves 6 px right and whose right half
    moves 5 px down: 'select' is inexact there by contract (the vertical
    sample read at column x1 used the flow of (y, x1)). The port's mean
    select-vs-exact EPE equals jitted JAX's within 1e-4 px (measured: equal
    to the printed digits, 0.196 px), and each mode's flow is within 1e-4 px
    of JAX's."""
    h, w, pad = 64, 96, 16
    rng = np.random.default_rng(7)
    base = _smooth(_smooth(rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad))))
    base = (base - base.min()) / np.ptp(base) * 255
    prev = base[pad : pad + h, pad : pad + w].copy()
    nxt = prev.copy()
    nxt[:, : w // 2] = base[pad : pad + h, pad - 6 : pad - 6 + w // 2]
    nxt[:, w // 2 :] = base[pad - 5 : pad - 5 + h, pad + w // 2 : pad + w]
    a, b = prev.astype(np.uint8)[None], nxt.astype(np.uint8)[None]
    flows = {}
    for mode in ("exact", "select"):
        jp = jfb.FarnebackParams(warp_mode=mode, warp_radius=8)
        flows["jax", mode] = np.asarray(jax.jit(lambda p, q, jp=jp: jfb.farneback_flow(p, q, jp))(a, b))
        flows["port", mode] = tfb.farneback_flow(torch.from_numpy(a), torch.from_numpy(b),
                                                 tfb.FarnebackParams(warp_mode=mode, warp_radius=8)).numpy()

    def epe(x, y):
        return float(np.sqrt(((x - y) ** 2).sum(-1)).mean())

    gap = {side: epe(flows[side, "select"], flows[side, "exact"]) for side in ("jax", "port")}
    assert gap["port"] > 0.05, gap  # the discontinuity shows
    assert abs(gap["port"] - gap["jax"]) <= 1e-4, gap
    for mode in ("exact", "select"):
        assert epe(flows["port", mode], flows["jax", mode]) <= 1e-4, mode
    # the two halves' motion is found
    np.testing.assert_allclose(np.median(flows["port", "exact"][0, :, :40], axis=(0, 1)), [6, 0], atol=0.1)
    np.testing.assert_allclose(np.median(flows["port", "exact"][0, :, 56:], axis=(0, 1)), [0, 5], atol=0.1)


def test_select_runs_no_kernel(monkeypatch):
    """`uses_kernels` is False for 'select' (JAX's fused gate takes 'fast'
    and 'fast16' only), so farneback_flow never calls the warp_m or
    box_solve wrappers in that mode; the per-level radius is
    max(8, warp_radius >> k), as JAX's."""
    assert not tfb.uses_kernels(tfb.FarnebackParams(warp_mode="select"))
    assert tfb.uses_kernels(tfb.FarnebackParams(warp_mode="fast"))

    def refuse(*args):
        raise AssertionError("a kernel wrapper was called")

    monkeypatch.setattr(kw, "warp_m", refuse)
    monkeypatch.setattr(kw, "box_solve", refuse)
    radii = []
    real = tfb.update_matrices

    def spy(r0, r1, dx, dy, warp_mode, warp_radius):
        radii.append((r0.shape[-2], warp_mode, warp_radius))
        return real(r0, r1, dx, dy, warp_mode, warp_radius)

    monkeypatch.setattr(tfb, "update_matrices", spy)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, 256, (1, 160, 160), dtype=np.uint8))
    flow = tfb.farneback_flow(a, torch.roll(a, 2, -1), tfb.FarnebackParams(warp_mode="select", warp_radius=64))
    assert bool(torch.isfinite(flow).all())
    # 160 → levels 2 (40 px): radius 64 >> 2 = 16, 64 >> 1 = 32, 64; three iterations each
    assert radii == [(h, "select", r) for h, r in ((40, 16), (80, 32), (160, 64)) for _ in range(3)]


def _clip_frames(n=7, h=64, w=96, seed=5):
    from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

    return synth_frames(n, h, w, seed=seed)


def test_select_passes_through_the_pipelines(tmp_path, monkeypatch):
    """process_frames, the stream, the sequential and dp×sp queues and the
    temporal split hand `FarnebackParams(warp_mode='select',
    warp_radius=16)` to the flow as given (no path filters the mode), and
    their tables agree: the stream's and the queue's bitwise equal
    process_frames', the dp×sp ones equal the unsharded pipeline's."""
    from opticalflowclustering_tpu.io.video import write_video_mjpg
    from opticalflowclustering_tpu_torch.io.video import read_video_bgr
    from opticalflowclustering_tpu_torch.parallel import temporal
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.pipeline import queue

    seen = set()
    real = tfb.farneback_flow

    def spy(prev, nxt, params=tfb.FarnebackParams()):
        seen.add((params.warp_mode, params.warp_radius))
        return real(prev, nxt, params)

    monkeypatch.setattr(tpl, "farneback_flow", spy)
    monkeypatch.setattr(temporal, "farneback_flow", spy)
    params = tfb.FarnebackParams(warp_mode="select", warp_radius=16)
    cfg = tpl.PipelineConfig(chunk=4, emit_flow_bgr=False, flow=params)
    path = str(tmp_path / "clip.avi")
    write_video_mjpg(path, _clip_frames(), 30.0)
    frames = read_video_bgr(path)
    want = tpl.process_frames(frames, cfg, device="cpu")
    stream = tpl.process_video_stream(path, cfg, device="cpu")
    for k in ("hue_table", "rgb_hue_table", "centroids", "mean_magnitude"):
        np.testing.assert_array_equal(stream[k], want[k], err_msg=k)
    res = queue.process_video_queue([path], str(tmp_path / "q"), cfg, device="cpu")
    assert [r.ok for r in res] == [True]
    got = queue.load_features(res[0].path)
    np.testing.assert_array_equal(got["hue_table"], want["hue_table"])
    videos = np.stack([_clip_frames(8, seed=s) for s in (5, 6)])
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    sharded = temporal.sharded_hue_pipeline_videos(videos, mesh, params=params)
    local = temporal.unsharded_hue_pipeline_videos(videos, params=params, device="cpu")
    for a, b in zip(sharded, local):
        a, b = np.asarray(a)[:, :-1], np.asarray(b)[:, :-1]
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)
    assert seen == {("select", 16)}


def test_kmeangrids_select_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """jcli.main ↔ tcli.main --device cpu with --warp-mode select --noyolo
    --nocontour on the first 28 frames of demo_out/601_3.avi: OutCSV and
    the -f rows byte-equal (measured: every cell equal)."""
    from opticalflowclustering_tpu.cli import kmeangrids as jcli
    from opticalflowclustering_tpu_torch.cli import kmeangrids as tcli

    written = {}
    for side, main, extra in (("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        main(["-d", "OutImgs/601_3", "-c", "1", "-f", "a.csv", "--noyolo", "--nocontour", "--path", DEMO,
              "--max-frames", str(CLI_FRAMES), "--warp-mode", "select"] + extra)
        written[side] = ((d / "OutCSV" / "601_3.csv").read_bytes(), (d / "a.csv").read_bytes())
    assert written["port"] == written["jax"]
    assert written["port"][0].count(b"\n") == CLI_FRAMES
    assert f"OutCSV/601_3.csv: {CLI_FRAMES - 1} frames x 350 cells" in capsys.readouterr().out


def test_computeopticalflow_select_matches_jax_cli(tmp_path, capsys):
    """jcof.main ↔ tcof.main --device cpu with --warp-mode select on the
    first 28 frames of demo_out/601_3.avi. The CSVs' header, frame column
    and the 8 static pairs (magnitude 0.0) are byte-equal; the magnitudes of
    the moving pairs differ in the last digits of float32 (measured rel
    ≤ 6e-7: the JAX CLI computes the mean |flow| inside its jitted
    program, where XLA fuses the flow's arithmetic and picks its own
    summation order), so they are held within rtol 2e-6 and the count of
    lines that differ is pinned at most to the 19 moving pairs."""
    from opticalflowclustering_tpu.cli import computeopticalflow as jcof
    from opticalflowclustering_tpu_torch.cli import computeopticalflow as tcof

    clips = {}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        clips[side] = str(tmp_path / side / "601_3.avi")
        with open(DEMO, "rb") as src, open(clips[side], "wb") as dst:
            dst.write(src.read())
    jcof.main(["-i", clips["jax"], "--max-frames", str(CLI_FRAMES), "--warp-mode", "select"])
    tcof.main(["-i", clips["port"], "--max-frames", str(CLI_FRAMES), "--warp-mode", "select", "--device", "cpu"])
    assert f"Number of VideoFrames processed {CLI_FRAMES - 1} / {CLI_FRAMES}" in capsys.readouterr().out
    want = open(clips["jax"] + "_opticalFlow.csv").read().splitlines()
    got = open(clips["port"] + "_opticalFlow.csv").read().splitlines()
    assert len(got) == len(want) == CLI_FRAMES
    assert got[:9] == want[:9] and got[1].endswith(",0.0")
    differ = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    assert len(differ) <= CLI_FRAMES - 9, differ
    g = pd.read_csv(clips["port"] + "_opticalFlow.csv", index_col=0)
    w = pd.read_csv(clips["jax"] + "_opticalFlow.csv", index_col=0)
    np.testing.assert_array_equal(g["Frame"], w["Frame"])
    np.testing.assert_allclose(g["Average Magnitude"], w["Average Magnitude"], rtol=2e-6, atol=0)
    assert float(g["Average Magnitude"].max()) > 1.0  # real motion
