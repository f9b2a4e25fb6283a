"""PyTorch port vs the JAX package: training (opticalflowclustering_tpu_torch.
models.bounce_classifier, models.flow_cnn.train_flow_cnn and
parallel.train.make_fused_train_step ↔ the JAX modules of the same path).

Every comparison starts both sides from the JAX-initialised parameters,
loaded into the port through convert.from_flax_params, and feeds the port
the JAX side's data order and flips. Tolerances: make_train_step params
within 1e-6 after 10 AdamW steps; train_on_hue_windows' loss rel 1e-4 after
200 steps; train_flow_cnn params within 1e-4 after 2 Adam steps; the
fused step's losses rel 1e-5 and params within 1e-5 of JAX's 1×1 CPU mesh,
and the port's 2×2 mesh of CPU devices within rel 1e-5 (losses) and 1e-6
(params) of its 1×1. Where a parameter tolerance is wider than 1e-6 it is
Adam's: its update is about lr·m/√v, so a gradient within float rounding
of 0 can move a parameter by a different step on the two sides; the
losses, which every parameter feeds, are held tighter."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

from opticalflowclustering_tpu.features.grid import GridParams as JGrid
from opticalflowclustering_tpu.flow.farneback import FarnebackParams as JFlow
from opticalflowclustering_tpu.models import bounce_classifier as jbc
from opticalflowclustering_tpu.models import flow_cnn as jfc
from opticalflowclustering_tpu.parallel.train import make_fused_train_step as j_fused
from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.features.grid import GridParams
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
from opticalflowclustering_tpu_torch.models import bounce_classifier as tbc
from opticalflowclustering_tpu_torch.models import flow_cnn as tfc
from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
from opticalflowclustering_tpu_torch.parallel.train import make_fused_train_step as t_fused
from opticalflowclustering_tpu_torch.scripts.clips import synth_frames

torch.set_num_threads(1)


def _flat(params):
    flat, _ = jax.tree_util.tree_flatten_with_path(params)
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}


def _assert_params_close(model, jparams, atol):
    got, want = convert.to_flax_params(model), _flat(jparams)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=atol, rtol=0, err_msg=k)


def _port_classifier(jparams, feature_dim, hidden=64):
    model = tbc.BounceClassifier(feature_dim, hidden)
    model.load_state_dict(convert.from_flax_params("BounceClassifier", jparams))
    return model


def _hue_data(seed, n=48, d=9):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 180, (n, d)).astype(np.float32)
    y = (np.sin(x[:, 0] * np.pi / 90) > 0).astype(np.float32)
    return x, y


def test_bounce_classifier_forward_equals_flax():
    """jbc.BounceClassifier.apply ↔ tbc.BounceClassifier from the same
    parameters: logits within 1e-6 (sin/cos embedding, 64-wide MLP)."""
    x, _ = _hue_data(0)
    model, params = jbc.init_classifier(jax.random.PRNGKey(1), x.shape[1])
    want = np.asarray(model.apply(params, jnp.asarray(x)))
    got = _port_classifier(params, x.shape[1])(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape == (x.shape[0],)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_make_train_step_10_steps_equals_optax_adamw():
    """jbc.make_train_step with optax.adamw(1e-3) ↔ tbc.make_train_step with
    tbc.adamw (weight decay 1e-4 on every parameter, eps 1e-8): after 10
    steps from the same parameters every parameter is within 1e-6 and the
    losses within rel 1e-5. torch's own AdamW default (decay 1e-2) is not
    within that."""
    x, y = _hue_data(2)
    jmodel, params = jbc.init_classifier(jax.random.PRNGKey(0), x.shape[1])
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)
    jstep = jax.jit(jbc.make_train_step(jmodel, tx))
    model = _port_classifier(params, x.shape[1])
    tstep = tbc.make_train_step(model, tbc.adamw(model.parameters(), 1e-3))
    default = _port_classifier(params, x.shape[1])
    dstep = tbc.make_train_step(default, torch.optim.AdamW(default.parameters(), lr=1e-3))
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    for _ in range(10):
        params, opt_state, jloss = jstep(params, opt_state, jnp.asarray(x), jnp.asarray(y))
        tloss = tstep(xt, yt)
        dstep(xt, yt)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    _assert_params_close(model, params, 1e-6)
    with pytest.raises(AssertionError):
        _assert_params_close(default, params, 1e-6)


def test_train_on_hue_windows_200_steps_loss_equals_jax():
    """jbc.train_on_hue_windows ↔ the port's loop (tbc._fit, which
    tbc.train_on_hue_windows runs after its own initialisation) from JAX's
    initial parameters: the final loss within rel 1e-4 after 200 steps,
    every parameter within 1e-3. The
    public port trainer, from its own seeded initialisation, also learns
    (final loss below half the first)."""
    x, y = _hue_data(3)
    jparams, jloss = jbc.train_on_hue_windows(jnp.asarray(x), jnp.asarray(y), steps=200)
    _, init = jbc.init_classifier(jax.random.PRNGKey(0), x.shape[1])
    model = _port_classifier(init, x.shape[1])
    tloss = tbc._fit(model, torch.from_numpy(x), torch.from_numpy(y), 200, 1e-3)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)
    _assert_params_close(model, jparams, 1e-3)
    trained, loss = tbc.train_on_hue_windows(x, y, steps=200, device="cpu")
    first = torch.nn.functional.binary_cross_entropy_with_logits(
        tbc.init_classifier(None, x.shape[1], device="cpu")(torch.from_numpy(x)), torch.from_numpy(y))
    assert isinstance(trained, tbc.BounceClassifier) and loss < 0.5 * float(first)


def test_hue_windows_from_series_equals_jax():
    series = np.random.default_rng(4).integers(0, 180, 30)
    for w in (1, 5, 9):
        np.testing.assert_array_equal(tbc.hue_windows_from_series(series, w),
                                      jbc.hue_windows_from_series(series, w))


def test_train_flow_cnn_two_steps_equal_jax():
    """jfc.train_flow_cnn (one epoch of 2 steps, batch 8) ↔ the port's epoch
    (tfc._train_epoch) from the JAX initial parameters, with the JAX run's
    order (numpy default_rng(seed)) and flips (rebuilt from its epoch key):
    every parameter within 1e-4 and the accuracy equal. The public port
    trainer runs from its own initialisation and returns an accuracy in
    [0, 1]."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (16, 50, 50, 3), dtype=np.uint8)
    images[8:, :, :25] //= 4  # a class signal: darker left halves
    labels = np.array([1] * 8 + [0] * 8, np.int32)
    seed, batch, lr = 0, 8, 3e-3
    jparams, jacc = jfc.train_flow_cnn(images, labels, epochs=1, batch=batch, lr=lr, seed=seed)

    init = jfc.FlowCellNet().init(jax.random.PRNGKey(seed), jnp.zeros((1, 50, 50, 3), jnp.float32))
    model = tfc.FlowCellNet()
    model.load_state_dict(convert.from_flax_params("FlowCellNet", init))
    opt, sched = tfc._make_optimizer(model, lr, 2)
    order = np.random.default_rng(seed).permutation(16)
    key, flips = jax.random.PRNGKey(seed * 1000), []
    for _ in range(2):
        key, sub = jax.random.split(key)
        flips.append(np.asarray(jax.random.bernoulli(sub, 0.5, (batch, 1, 1, 1))).reshape(batch))
    tacc = tfc._train_epoch(
        model, opt, sched, torch.from_numpy(images[order]).reshape(2, batch, 50, 50, 3),
        torch.from_numpy(labels[order]).long().reshape(2, batch), torch.from_numpy(np.stack(flips)))
    _assert_params_close(model, jparams, 1e-4)
    assert tacc == pytest.approx(jacc, abs=1e-6)
    _, acc = tfc.train_flow_cnn(images, labels, epochs=1, batch=batch, lr=lr, device="cpu")
    assert 0.0 <= acc <= 1.0


GRID = (4, 6)


def _videos(b, n, h=48, w=72):
    return np.stack([synth_frames(n, h, w, seed=s) for s in range(b)])


def _labels(b, n):
    return (np.arange(b * n).reshape(b, n) % 3 == 0).astype(np.float32)


def _run_port_fused(mesh, jinit, videos, labels, steps, flow):
    model = _port_classifier(jinit, GRID[0] * GRID[1])
    opt = tbc.adamw(model.parameters(), 1e-2)
    step = t_fused(mesh, model, opt, grid=GridParams(*GRID), flow_params=flow)
    return model, [float(step(videos, labels)) for _ in range(steps)]


@pytest.fixture(scope="module")
def fused_case():
    videos = _videos(2, 4)
    labels = _labels(2, 4)
    _, jinit = jbc.init_classifier(jax.random.PRNGKey(0), GRID[0] * GRID[1])
    return videos, labels, jinit


def test_fused_train_step_1x1_equals_jax_1x1(fused_case):
    """j_fused on a 1×1 mesh of one JAX CPU device ↔ t_fused on a 1×1 mesh
    of the CPU, both with adamw(1e-2) from the same parameters over
    [2, 4, 48, 72, 3] clips and [2, 4] labels (the wrapped last pair of
    each video is labelled and counted on both sides): losses of 3 steps
    within rel 1e-5, parameters within 1e-5."""
    videos, labels, jinit = fused_case
    jmesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "sp"))
    jmodel = jbc.BounceClassifier()
    tx = optax.adamw(1e-2)
    jstep = j_fused(jmesh, jmodel, tx, grid=JGrid(*GRID), flow_params=JFlow())
    params, opt_state, jlosses = jinit, tx.init(jinit), []
    for _ in range(3):
        params, opt_state, loss = jstep(params, opt_state, jnp.asarray(videos), jnp.asarray(labels))
        jlosses.append(float(loss))
    model, tlosses = _run_port_fused(make_mesh({"dp": 1, "sp": 1}, ["cpu"]), jinit, videos, labels, 3,
                                     FarnebackParams())
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    _assert_params_close(model, params, 1e-5)


@pytest.mark.parametrize("warp_mode", ["exact", "fast"])
def test_fused_train_step_2x2_equals_1x1_with_the_wrapped_pair(fused_case, warp_mode, monkeypatch):
    """t_fused on a 2×2 mesh of CPU devices ↔ on a 1×1 mesh: losses of 3
    steps within rel 1e-5 and parameters within 1e-6. The wrapped pair is
    in the loss: relabelling only the last frame of each video changes the
    loss on both meshes. With warp_mode='fast' each block's flow goes
    through the warp_m/box_solve wrappers (made counted plain versions here,
    as on the card each wrapper counts its kernel's launches): 4 blocks ×
    levels × 3 iterations per step on the 2×2 mesh, a quarter of that on
    the 1×1; 'exact' goes through neither."""
    from opticalflowclustering_tpu_torch.flow.farneback import pyramid_plan
    from opticalflowclustering_tpu_torch.kernels import warp as kw

    for name, plain in (("warp_m", kw.warp_m_reference), ("box_solve", kw.box_solve_reference)):
        def run(*args, name=name, plain=plain):
            kw.LAUNCHES[name] += 1
            return plain(*args)

        monkeypatch.setattr(kw, name, run)
    videos, labels, jinit = fused_case
    flow = FarnebackParams(warp_mode=warp_mode)
    kw.reset_launches()
    m22, l22 = _run_port_fused(make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4), jinit, videos, labels, 3, flow)
    n22 = dict(kw.LAUNCHES)
    kw.reset_launches()
    m11, l11 = _run_port_fused(make_mesh({"dp": 1, "sp": 1}, ["cpu"]), jinit, videos, labels, 3, flow)
    n11 = dict(kw.LAUNCHES)
    np.testing.assert_allclose(l22, l11, rtol=1e-5)
    for (k, a), b in zip(m22.state_dict().items(), m11.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6, msg=k)
    per_flow = len(pyramid_plan(48, 72, flow)) * flow.iterations
    if warp_mode == "fast":
        assert n22 == {"warp_m": 12 * per_flow, "box_solve": 12 * per_flow, "gauss_solve": 0}
        assert n11 == {"warp_m": 3 * per_flow, "box_solve": 3 * per_flow, "gauss_solve": 0}
    else:
        assert n22 == n11 == {"warp_m": 0, "box_solve": 0, "gauss_solve": 0}
    wrapped = labels.copy()
    wrapped[:, -1] = 1 - wrapped[:, -1]
    for shape in ({"dp": 2, "sp": 2}, {"dp": 1, "sp": 1}):
        mesh = make_mesh(shape, ["cpu"] * (shape["dp"] * shape["sp"]))
        _, (a,) = _run_port_fused(mesh, jinit, videos, labels, 1, flow)
        _, (b,) = _run_port_fused(mesh, jinit, videos, wrapped, 1, flow)
        assert abs(a - b) > 1e-4, shape


def test_fused_train_step_rejects_an_uneven_split(fused_case):
    videos, labels, jinit = fused_case
    model = _port_classifier(jinit, GRID[0] * GRID[1])
    step = t_fused(make_mesh({"dp": 1, "sp": 3}, ["cpu"] * 3), model, tbc.adamw(model.parameters(), 1e-2))
    with pytest.raises(ValueError, match="does not divide"):
        step(videos, labels)
