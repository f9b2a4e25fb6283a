"""Driver entry points of the port (port of `__graft_entry__.py`): the
forward step of one chunk on one device, and a dryrun of every parallel path
over an n-device mesh.

    python -m opticalflowclustering_tpu_torch.graft_entry [--device cuda|cpu]

On `cuda` the dryrun's mesh takes every visible card; on `cpu` it names the
CPU 4 times.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import resolve_device


def entry(device: str | torch.device = "cuda"):
    """(forward, (frames,)): the forward step of the bounce pipeline —
    Farneback flow → HSV render → grid cells → dominant-hue rows — for a
    chunk of 720p frame pairs (the per-chunk unit of
    `pipeline.bounce.process_frames`), on `device`. forward returns
    (hue_table, rgb_hue_table, mean_magnitude) on that device."""
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, chunk_step

    cfg = PipelineConfig(chunk=4)
    dev = resolve_device(device)

    def forward(frames_chunk):
        out = chunk_step(frames_chunk, cfg, dev)
        return out["hue_table"], out["rgb_hue_table"], out["mean_magnitude"]

    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(5, 720, 1280, 3), dtype=np.uint8)
    return forward, (frames,)


def _numpy(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_pipeline_match(sharded, local, tag: str) -> None:
    """The hue and centroid tables (integer math) bitwise equal across mesh
    shapes; mean_magnitude, float telemetry whose reduction order may follow
    the block shape, within rtol 1e-6."""
    for name, s, l in zip(("hue", "rgb_hue", "centroids"), sharded[:3], local[:3]):
        s, l = _numpy(s), _numpy(l)
        assert s.shape == l.shape and np.array_equal(s, l), f"{tag}sharded pipeline {name} diverges from unsharded"
    s, l = _numpy(sharded[3]), _numpy(local[3])
    assert s.shape == l.shape and np.allclose(s, l, rtol=1e-6), (
        f"{tag}sharded pipeline mean_mag diverges from unsharded: "
        f"max rel {np.abs(s - l).max() / max(np.abs(l).max(), 1e-9):.2e}"
    )


def _mesh_devices(n_devices: int, device, devices) -> list[torch.device]:
    from opticalflowclustering_tpu_torch.parallel.mesh import cuda_devices

    if devices is None:
        dev = resolve_device(device)
        devices = cuda_devices() if dev.type == "cuda" else [dev] * n_devices
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_devices:
        raise ValueError(f"a {n_devices}-device mesh needs {n_devices} devices; {len(devices)} given")
    return devices[:n_devices]


def dryrun_multichip(n_devices: int, device: str | torch.device = "cuda", devices=None) -> dict:
    """Every pass of the JAX package's dryrun over an n_devices mesh, at its
    shapes and with its asserts:

    1.   the bounce pipeline (sharded_hue_pipeline_videos) on a dp×sp mesh,
         tables bitwise equal to the unsharded pipeline's;
    1.5  one frame's rows sharded across all n devices (spatial_farneback_flow)
         against the unsharded flow, within 5e-5 px;
    1.6  the padded entry at 720 rows, the interior within 5e-5 px;
    1.7  the spatially sharded hue pipeline, tables equal;
    1.75 512×128 frames, the default 3-level pyramid in 'fast' (the warp_m
         and box_solve kernels on the card), tables bitwise;
    2.   one fused dp×sp train step with AdamW(1e-3), a finite loss.

    `devices`: the mesh's devices (default: every visible card on `cuda`,
    the CPU n times on `cpu`); `[card] * n` lays the mesh over one card.
    Prints one line per pass with the kernel launches it made, and returns
    those launches by pass."""
    from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
    from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
    from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
    from opticalflowclustering_tpu_torch.kernels import poly as kp
    from opticalflowclustering_tpu_torch.kernels import pyramid as kpyr
    from opticalflowclustering_tpu_torch.kernels import warp as kw
    from opticalflowclustering_tpu_torch.models.bounce_classifier import adamw, init_classifier
    from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
    from opticalflowclustering_tpu_torch.parallel.spatial import (
        spatial_farneback_flow,
        spatial_farneback_flow_padded,
        spatial_hue_pipeline,
    )
    from opticalflowclustering_tpu_torch.parallel.temporal import (
        sharded_hue_pipeline_videos,
        unsharded_hue_pipeline_videos,
    )
    from opticalflowclustering_tpu_torch.parallel.train import make_fused_train_step

    devs = _mesh_devices(n_devices, device, devices)
    home = devs[0]
    dp = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    sp = n_devices // dp
    mesh = make_mesh({"dp": dp, "sp": sp}, devs)
    grid = GridParams(4, 6)
    b, n, h, w = dp * 2, sp * 2, 64, 96
    launches = {}

    def done(name: str, line: str) -> None:
        if home.type == "cuda":
            torch.cuda.synchronize(home)
        launches[name] = {**kw.LAUNCHES, **kp.LAUNCHES, **kpyr.LAUNCHES}
        print(f"{line}; launches {launches[name]}", flush=True)
        kw.reset_launches()
        kp.reset_launches()
        kpyr.reset_launches()

    def gray(a):
        return torch.from_numpy(a).to(home)

    kw.reset_launches()
    kp.reset_launches()
    kpyr.reset_launches()

    # --- pass 1: the pipeline, sharded vs unsharded, bitwise ---
    rng = np.random.default_rng(1)
    vids = rng.integers(0, 256, size=(b, n, h, w, 3), dtype=np.uint8)
    flow_params = FarnebackParams(levels=1)
    sharded = sharded_hue_pipeline_videos(vids, mesh, grid=grid, params=flow_params)
    local = unsharded_hue_pipeline_videos(vids, grid=grid, params=flow_params, device=home)
    _assert_pipeline_match(sharded, local, "")
    done("1", f"dryrun_multichip: flagship pipeline ok (bitwise) on dp={dp}×sp={sp} mesh — hue table "
              f"{tuple(sharded[0].shape)}")

    # --- pass 1.5: spatial tensor parallelism (row-sharded Farneback) ---
    tp_mesh = make_mesh({"tp": n_devices}, devs)
    sp_params = FarnebackParams(levels=1, warp_radius=8)
    h_tp = n_devices * 48  # > the 38-row halo per shard at these params
    rng = np.random.default_rng(2)
    prev = rng.integers(0, 256, size=(h_tp, 96), dtype=np.uint8)
    nxt = rng.integers(0, 256, size=(h_tp, 96), dtype=np.uint8)
    ref_flow = farneback_flow(gray(prev), gray(nxt), sp_params)
    tp_flow = spatial_farneback_flow(prev, nxt, tp_mesh, "tp", sp_params)
    sp_diff = float((ref_flow - tp_flow.to(home)).abs().max())
    assert sp_diff <= 5e-5, f"spatial TP diverges: max abs {sp_diff}"
    done("1.5", f"dryrun_multichip: spatial TP ok (max |Δ| {sp_diff:.1e} px) — {h_tp}-row frame across "
                f"{n_devices} row shards")

    # --- pass 1.6: the padded entry at 720 rows ---
    h_pad = 720
    rng = np.random.default_rng(5)
    prev_p = rng.integers(0, 256, size=(h_pad, 96), dtype=np.uint8)
    nxt_p = rng.integers(0, 256, size=(h_pad, 96), dtype=np.uint8)
    tp_pad = spatial_farneback_flow_padded(prev_p, nxt_p, tp_mesh, "tp", sp_params).to(home)
    assert tuple(tp_pad.shape) == (h_pad, 96, 2), tuple(tp_pad.shape)
    ref_pad = farneback_flow(gray(prev_p), gray(nxt_p), sp_params)
    # away from the bottom border the replicate-pad is invisible
    interior = slice(0, h_pad - 64)
    pad_diff = float((ref_pad[interior] - tp_pad[interior]).abs().max())
    assert pad_diff <= 5e-5, f"padded spatial TP diverges: {pad_diff}"
    assert bool(torch.isfinite(tp_pad).all())
    done("1.6", f"dryrun_multichip: padded spatial TP ok ({h_pad} rows on {n_devices} shards, interior max "
                f"|Δ| {pad_diff:.1e} px)")

    # --- pass 1.7: the spatially sharded hue pipeline ---
    hue_grid = GridParams(4, 4)
    hue_t, rgb_hue_t, cen_t, mm_t = spatial_hue_pipeline(prev, nxt, tp_mesh, "tp", hue_grid, sp_params)
    bgr_ref = render_flow_hsv_bgr(farneback_flow(gray(prev), gray(nxt), sp_params))
    cen_ref, hue_ref = dominant_hue_k1_frames(bgr_ref, hue_grid)
    rgb_ref = grid_mean_hue(bgr_ref, hue_grid)
    assert np.array_equal(_numpy(hue_t), _numpy(hue_ref))
    assert np.array_equal(_numpy(rgb_hue_t), _numpy(rgb_ref))
    assert np.array_equal(_numpy(cen_t), _numpy(cen_ref))
    done("1.7", f"dryrun_multichip: spatial-TP hue pipeline ok (feature tables equal) — pmin/pmax frame range "
                f"+ all_gather on {n_devices} row shards, mean |flow| {float(mm_t):.3f} px")

    # --- pass 1.75: 512-row frames, the default 3-level pyramid, 'fast' ---
    big_grid = GridParams(8, 8)
    big_params = FarnebackParams(warp_mode="fast")
    rng = np.random.default_rng(3)
    base = rng.integers(0, 256, size=(2, 560, 160), dtype=np.uint8)
    n_big = max(sp * 2, 2)
    vids_big = np.empty((dp, n_big, 512, 128, 3), np.uint8)
    for v in range(dp):
        for t in range(n_big):
            shifted = np.roll(np.roll(base[v], 9 * t, axis=0), 4 * t, axis=1)[:512, :128]
            vids_big[v, t] = shifted[..., None]
    sharded_b = sharded_hue_pipeline_videos(vids_big, mesh, grid=big_grid, params=big_params)
    local_b = unsharded_hue_pipeline_videos(vids_big, grid=big_grid, params=big_params, device=home)
    _assert_pipeline_match(sharded_b, local_b, "big-geometry ")
    mm = _numpy(sharded_b[3])[:, : n_big - 1]
    done("1.75", f"dryrun_multichip: near-flagship geometry ok (bitwise) — {vids_big.shape[0]}x{vids_big.shape[1]} "
                 f"frames of 512x128 on dp={dp}x sp={sp}, 3-level 'fast' warp, mean |flow| {float(mm.mean()):.2f} "
                 f"px (motion binds reach_k/halo margins)")

    # --- pass 2: one fused dp×sp train step ---
    model = init_classifier(torch.Generator().manual_seed(0), grid.rows * grid.cols, device=home)
    step = make_fused_train_step(mesh, model, adamw(model.parameters(), 1e-3), grid=grid,
                                 flow_params=FarnebackParams(levels=1))
    rng = np.random.default_rng(0)
    videos = rng.integers(0, 256, size=(b, n, h, w, 3), dtype=np.uint8)
    labels = rng.integers(0, 2, size=(b, n)).astype(np.float32)
    loss = float(step(videos, labels))
    assert np.isfinite(loss), f"non-finite loss {loss}"
    done("2", f"dryrun_multichip: mesh dp={dp}×sp={sp} over {n_devices} devices, one fused train step ok, "
              f"loss={loss:.4f}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    fn, fargs = entry(dev)
    out = fn(*fargs)
    print("entry ok:", [tuple(t.shape) for t in out])
    dryrun_multichip(torch.cuda.device_count() if dev.type == "cuda" else 4, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
