"""PyTorch port vs the JAX package: the row-sharded (spatial) Farneback flow
and hue pipeline (opticalflowclustering_tpu_torch.parallel.spatial ↔
opticalflowclustering_tpu.parallel.spatial and the unsharded flow).

On the CPU a `tp` mesh names the CPU several times, which lays the row
blocks, their halos and the edge-block border emulation over one device. The
port's sharded flow is held bitwise to the port's unsharded exact-mode
`farneback_flow` (the exactness the JAX package shows op by op,
tests/test_spatial_tp.py::test_spatial_tp_bitwise_eager), and against JAX's
own `spatial_farneback_flow`: jitted within its 5e-5 px fusion tolerance in
tier 1, and bitwise under `jax.disable_jit()` in a `slow` case (JAX's eager
shard_map takes minutes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.parallel import spatial as jspatial
from opticalflowclustering_tpu_torch import parallel
from opticalflowclustering_tpu_torch.convert import from_jax_config
from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
from opticalflowclustering_tpu_torch.features.grid import GridParams, grid_mean_hue
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr, render_flow_hsv_bgr_given_range
from opticalflowclustering_tpu_torch.ops.polar import magnitude
from opticalflowclustering_tpu_torch.parallel import spatial
from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)

FUSION_TOL = 5e-5  # px: the JAX package's jitted-vs-unsharded contract
PARAMS = FarnebackParams(levels=2)


def _smooth(a: np.ndarray, r: int = 8) -> np.ndarray:
    k = 2 * r + 1
    c = np.cumsum(np.pad(a, ((r + 1, r), (0, 0)), mode="edge"), axis=0)
    a = (c[k:] - c[:-k]) / k
    c = np.cumsum(np.pad(a, ((0, 0), (r + 1, r)), mode="edge"), axis=1)
    return (c[:, k:] - c[:, :-k]) / k


def _moving_pair(h: int, w: int, dy: int, dx: int, seed: int = 0):
    """tests/test_spatial_tp.py's smooth texture moved by (dy, dx)."""
    rng = np.random.default_rng(seed)
    pad = 32
    base = rng.uniform(0, 255, size=(h + 2 * pad, w + 2 * pad)).astype(np.float32)
    base = _smooth(_smooth(base))
    base = (base - base.min()) / (np.ptp(base) + 1e-9) * 255.0
    prev = base[pad : pad + h, pad : pad + w].astype(np.uint8)
    nxt = base[pad + dy : pad + dy + h, pad + dx : pad + dx + w].astype(np.uint8)
    return prev, nxt


def _tp(n: int):
    return make_mesh({"tp": n}, ["cpu"] * n)


def _flow(prev, nxt, params=PARAMS):
    return farneback_flow(torch.as_tensor(prev), torch.as_tensor(nxt), params)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_spatial_flow_bitwise_equals_unsharded(tp):
    """JAX's anchor geometry (256×96, levels 2, motion (dy, dx) = (2, 1)):
    the sharded flow on 1, 2 and 4 row blocks is bitwise the unsharded
    exact-mode flow, with warp_mode 'fast' asked for too (the spatial flow
    is always the exact warp)."""
    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=1)
    want = _flow(prev, nxt)
    for params in (PARAMS, FarnebackParams(levels=2, warp_mode="fast")):
        got = spatial.spatial_farneback_flow(prev, nxt, _tp(tp), "tp", params)
        assert got.shape == (256, 96, 2) and got.dtype == torch.float32
        assert torch.equal(got, want), float((got - want).abs().max())
    assert float(want[..., 1].median()) < -0.2  # the flow follows the upward motion


def test_spatial_flow_batched_and_default_pyramid():
    """A batch of two pairs, and the default 3-level pyramid at 720×128 on 4
    blocks (pads to 736 rows): bitwise the unsharded flow."""
    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=1)
    pb, nb = np.stack([prev, nxt]), np.stack([nxt, prev])
    got = spatial.spatial_farneback_flow(pb, nb, _tp(4), "tp", PARAMS)
    assert got.shape == (2, 256, 96, 2) and torch.equal(got, _flow(pb, nb))
    assert torch.equal(got[0], _flow(prev, nxt))
    prev, nxt = _moving_pair(720, 128, dy=4, dx=2, seed=3)
    got = spatial.spatial_farneback_flow_padded(prev, nxt, _tp(4), "tp", FarnebackParams())
    pp, np_ = (np.concatenate([a, np.repeat(a[-1:], 16, 0)]) for a in (prev, nxt))
    assert got.shape == (720, 128, 2)
    assert torch.equal(got, _flow(pp, np_, FarnebackParams())[:720])


def test_spatial_flow_wide_window_equals_unsharded():
    """winsize 19, wider than the box_solve kernel's 17 (the solve takes the
    plain step there, as farneback_flow does): still bitwise the unsharded
    flow on 4 blocks."""
    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=1)
    params = FarnebackParams(levels=2, winsize=19)
    got = spatial.spatial_farneback_flow(prev, nxt, _tp(4), "tp", params)
    assert torch.equal(got, _flow(prev, nxt, params))


def test_spatial_flow_padded_non_divisible():
    """250 rows on 4 blocks at levels 2 (250 % 16 = 10): the padded entry
    equals the unsharded flow of the replicate-padded frame, cropped; rows
    away from the bottom border match the flow of the original frame within
    0.05 px (JAX's test_spatial_tp_padded_non_divisible)."""
    h = 250
    prev, nxt = _moving_pair(h, 96, dy=2, dx=1, seed=2)
    got = spatial.spatial_farneback_flow_padded(prev, nxt, _tp(4), "tp", PARAMS)
    assert got.shape == (h, 96, 2)
    pp, np_ = (np.concatenate([a, np.repeat(a[-1:], 6, 0)]) for a in (prev, nxt))
    assert torch.equal(got, _flow(pp, np_)[:h])
    interior = slice(0, h - 120)
    epe = torch.linalg.vector_norm((got - _flow(prev, nxt))[interior], dim=-1).max()
    assert float(epe) < 0.05
    # a divisible height goes straight through
    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=1)
    assert torch.equal(spatial.spatial_farneback_flow_padded(prev, nxt, _tp(4), "tp", PARAMS), _flow(prev, nxt))


def test_spatial_geometry_errors_and_cuda_refusal():
    """An indivisible height and a block below the largest halo raise
    ValueError, as in JAX; a mesh naming CUDA where there is none raises."""
    z = np.zeros((100, 96), np.uint8)
    with pytest.raises(ValueError, match="must divide"):
        spatial.spatial_farneback_flow(z, z, _tp(4), "tp", PARAMS)
    small = FarnebackParams(levels=1, warp_radius=8)
    z = np.zeros((128, 96), np.uint8)  # 32-row blocks, a 38-row halo at levels 1, warp_radius 8
    with pytest.raises(ValueError, match="too small"):
        spatial.spatial_farneback_flow(z, z, _tp(4), "tp", small)
    with pytest.raises(ValueError, match="too small"):
        spatial.spatial_hue_pipeline(z, z, _tp(4), "tp", GridParams(4, 4), small)
    for h, n, params in ((100, 4, PARAMS), (128, 4, small), (256, 4, PARAMS)):
        jparams = JFlow(levels=params.levels, warp_radius=params.warp_radius)
        try:
            jspatial._check_shard_geometry(h, 96, n, jparams)
            jax_ok = True
        except ValueError:
            jax_ok = False
        try:
            spatial._check_shard_geometry(h, 96, n, params)
            ok = True
        except ValueError:
            ok = False
        assert ok == jax_ok, (h, n, params.warp_radius)
        assert spatial._level_margins(params) == jspatial._level_margins(jparams)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            spatial.spatial_farneback_flow(z, z, make_mesh({"tp": 2}, ["cuda"] * 2), "tp", PARAMS)


@pytest.mark.parametrize("radius", [8, 16, 32, 64])
def test_converted_warp_radius_sets_the_shard_geometry(radius):
    """`warp_radius` carries across `from_jax_config`, so the port's
    _level_margins(params) equals JAX's for the JAX params, and the port's
    _check_shard_geometry accepts and refuses the frames JAX's does on tp=4
    at levels 1. At warp_radius 8 (the JAX dryrun's spatial params) both
    accept 160- and 192-row frames: a 38-row halo, not the 54 rows of the
    default 32 that the port used while it dropped the field."""
    jparams = JFlow(levels=1, warp_radius=radius)
    params = from_jax_config(jparams)
    assert params.warp_radius == radius
    assert spatial._level_margins(params) == jspatial._level_margins(jparams)
    for h in (160, 192, 256, 512):
        try:
            jspatial._check_shard_geometry(h, 96, 4, jparams)
            jax_ok = True
        except ValueError:
            jax_ok = False
        try:
            spatial._check_shard_geometry(h, 96, 4, params)
            ok = True
        except ValueError:
            ok = False
        assert ok == jax_ok, (h, radius)
        if radius == 8 and h in (160, 192):
            assert ok, h


def test_converted_dryrun_params_shard_160_rows_bitwise():
    """JAX's dryrun spatial params, FarnebackParams(levels=1,
    warp_radius=8), converted: the port's spatial flow takes a 160-row frame
    on tp=4 (40-row blocks over a 38-row halo) and is bitwise the unsharded
    exact flow."""
    params = from_jax_config(JFlow(levels=1, warp_radius=8))
    prev, nxt = _moving_pair(160, 96, dy=2, dx=1, seed=6)
    got = spatial.spatial_farneback_flow(prev, nxt, _tp(4), "tp", params)
    assert got.shape == (160, 96, 2)
    assert torch.equal(got, _flow(prev, nxt, params))


def _smallest_jax_case():
    """The smallest geometry _check_shard_geometry admits at the dryrun's
    parameters (levels 1, warp_radius 8: a 38-row halo): 80×64 on 2 blocks."""
    rng = np.random.default_rng(0)
    prev = rng.integers(0, 256, (80, 64), dtype=np.uint8)
    return prev, np.roll(prev, (1, 2), (0, 1)), JFlow(levels=1, warp_radius=8, warp_mode="exact")


def _port_smallest(prev, nxt):
    return spatial.spatial_farneback_flow(prev, nxt, _tp(2), "tp", FarnebackParams(levels=1, warp_radius=8)).numpy()


def test_spatial_flow_matches_jax_jitted():
    """JAX's spatial_farneback_flow (its production jitted program) ↔ the
    port's at 80×64 on 2 blocks: within the JAX package's 5e-5 px fusion
    tolerance (measured 1.2e-6)."""
    prev, nxt, jparams = _smallest_jax_case()
    with pytest.raises(ValueError, match="too small"):
        spatial._check_shard_geometry(76, 64, 2, FarnebackParams(levels=1, warp_radius=8))
    mesh = JMesh(np.array(jax.devices()[:2]), ("tp",))
    want = np.asarray(jspatial.spatial_farneback_flow(jnp.asarray(prev), jnp.asarray(nxt), mesh, "tp", jparams))
    got = _port_smallest(prev, nxt)
    assert got.shape == want.shape == (80, 64, 2)
    assert float(np.abs(got - want).max()) <= FUSION_TOL


@pytest.mark.slow
def test_spatial_flow_bitwise_equals_jax_eager():
    """JAX's spatial_farneback_flow under jax.disable_jit() ↔ the port's at
    80×64 on 2 blocks: bitwise (about 4 minutes of JAX's eager shard_map on
    one CPU thread)."""
    prev, nxt, jparams = _smallest_jax_case()
    mesh = JMesh(np.array(jax.devices()[:2]), ("tp",))
    with jax.disable_jit():
        want = np.asarray(jspatial.spatial_farneback_flow(jnp.asarray(prev), jnp.asarray(nxt), mesh, "tp", jparams))
    np.testing.assert_array_equal(_port_smallest(prev, nxt), want)


def _unsharded_tables(prev, nxt, grid, params):
    flow = _flow(prev, nxt, params)
    bgr = render_flow_hsv_bgr(flow)
    centroids, hue = dominant_hue_k1_frames(bgr, grid)
    return hue, grid_mean_hue(bgr, grid), centroids, magnitude(flow[..., 0], flow[..., 1]).mean()


def test_spatial_hue_pipeline_equals_unsharded():
    """spatial_hue_pipeline on 4 blocks ↔ the unsharded flow → render →
    grid (JAX's test_spatial_hue_pipeline_bitwise_eager geometry): integer
    tables equal, mean_mag within rtol 1e-6; a batch of two pairs too; the
    render with the blocks' range equals the render with the frame's."""
    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=4)
    grid = GridParams(4, 4)
    got = spatial.spatial_hue_pipeline(prev, nxt, _tp(4), "tp", grid, PARAMS)
    want = _unsharded_tables(prev, nxt, grid, PARAMS)
    assert tuple(got[0].shape) == (16,) and tuple(got[2].shape) == (16, 4) and tuple(got[3].shape) == ()
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-6)
    pb, nb = np.stack([prev, nxt]), np.stack([nxt, prev])
    got_b = spatial.spatial_hue_pipeline(pb, nb, _tp(2), "tp", grid, PARAMS)
    assert torch.equal(got_b[0][0], got[0]) and tuple(got_b[3].shape) == (2,)
    flow = _flow(prev, nxt)
    mag = magnitude(flow[..., 0], flow[..., 1])
    assert torch.equal(render_flow_hsv_bgr_given_range(flow, mag.amin(), mag.amax()), render_flow_hsv_bgr(flow))


def test_spatial_hue_pipeline_matches_jax_unsharded():
    """The port's spatial_hue_pipeline on 4 blocks ↔ the JAX package's
    unsharded pipeline (exact flow → render → grid, un-jitted) at 256×96,
    levels 2: integer tables equal, mean_mag within rtol 1e-5 (the rule of
    tests/test_torch_parallel.py for the temporal tables)."""
    from opticalflowclustering_tpu.features.dominant_color import dominant_hue_k1_frames as j_dom
    from opticalflowclustering_tpu.features.grid import grid_mean_hue as j_grid_mean_hue
    from opticalflowclustering_tpu.flow.farneback import farneback_flow as j_flow
    from opticalflowclustering_tpu.flow.render import render_flow_hsv_bgr as j_render
    from opticalflowclustering_tpu.ops.polar import magnitude as j_mag

    prev, nxt = _moving_pair(256, 96, dy=2, dx=1, seed=5)
    jgrid, jparams = JGrid(rows=4, cols=4), JFlow(warp_mode="exact", levels=2)
    flow = j_flow(jnp.asarray(prev), jnp.asarray(nxt), jparams)
    bgr = j_render(flow)
    cen, hue = j_dom(bgr, jgrid)
    want = (hue, j_grid_mean_hue(bgr, jgrid), cen, jnp.mean(j_mag(flow[..., 0], flow[..., 1])))
    got = spatial.spatial_hue_pipeline(prev, nxt, _tp(4), "tp", from_jax_config(jgrid), from_jax_config(jparams))
    for a, b in zip(got[:3], want[:3]):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(float(got[3]), float(want[3]), rtol=1e-5)


def test_parallel_exports_match_jax():
    """The port's parallel package exports the JAX package's names."""
    from opticalflowclustering_tpu import parallel as jparallel

    names = ("make_mesh", "sharded_hue_pipeline", "sharded_hue_pipeline_videos", "temporal_shard_flow",
             "spatial_farneback_flow", "spatial_farneback_flow_padded", "spatial_hue_pipeline")
    for name in names:
        assert hasattr(jparallel, name) and callable(getattr(parallel, name)), name
    assert parallel.spatial_hue_pipeline is spatial.spatial_hue_pipeline
