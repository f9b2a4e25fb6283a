"""PyTorch port vs the JAX package: k-means, LAB and colour quantization
(opticalflowclustering_tpu_torch.cluster.kmeans / ops.lab / extras.quantize
↔ the JAX modules of the same path).

JAX's PRNG cannot be reproduced in torch, so every comparison feeds the
port's inner functions the draws JAX made, rebuilt here with
jax.random.split / randint / uniform / permutation exactly as the JAX
functions make them; or compares where the result does not depend on the
draws. Tolerances: centres rtol 1e-5 (atol 1e-4 for values near 0), labels
equal; LAB codes and repainted pixels as stated per test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.extras.quantize import quantize_colors as jquant
from opticalflowclustering_tpu.ops import lab as jlab
from opticalflowclustering_tpu_torch.cluster import kmeans as tkm
from opticalflowclustering_tpu_torch.extras.quantize import _repaint
from opticalflowclustering_tpu_torch.extras.quantize import quantize_colors as tquant
from opticalflowclustering_tpu_torch.ops import lab as tlab

# The JAX package's cluster/__init__ binds `kmeans` to the function, which
# hides the module of that name from `from ... import kmeans`.
jkm = importlib.import_module("opticalflowclustering_tpu.cluster.kmeans")

torch.set_num_threads(1)


def _blobs(seed, n=600, k=4, d=3, spread=4.0):
    """Seeded Gaussian blobs [n, d] float32 around k separated centres."""
    rng = np.random.default_rng(seed)
    mus = rng.uniform(0, 200, (k, d))
    pts = mus[rng.integers(0, k, n)] + rng.normal(0, spread, (n, d))
    return pts.astype(np.float32)


def _jax_plusplus_draws(key, p, k):
    """The draws jkm._plusplus_init makes: randint for the first centre,
    then per later centre a split and the uniforms of jax.random.choice."""
    first = int(jax.random.randint(key, (), 0, p))
    L = tkm._n_local_trials(k)
    us = []
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        us.append(np.asarray(jax.random.uniform(sub, (L,), jnp.float32)))
    return torch.tensor(first), torch.from_numpy(np.stack(us))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed,k", [(0, 3), (1, 5), (2, 8)])
def test_plusplus_init_equals_jax_from_jax_draws(seed, k):
    """jkm._plusplus_init (read as jkm.kmeans(..., n_iter=0)) ↔
    tkm._plusplus_from_draws fed JAX's draws: the same points chosen, so
    the centres are bitwise equal."""
    x = _blobs(seed)
    key = jax.random.PRNGKey(seed)
    want, _ = jkm.kmeans(jnp.asarray(x), k, key, n_iter=0)
    first, u = _jax_plusplus_draws(key, x.shape[0], k)
    got = tkm._plusplus_from_draws(torch.from_numpy(x), k, first, u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("relocate_empty", [False, True])
@pytest.mark.parametrize("seed,k", [(3, 4), (4, 6)])
def test_lloyd_equals_jax_from_jax_init(seed, k, relocate_empty):
    """jkm.kmeans ↔ tkm._lloyd from JAX's ++ centres (kmeans(n_iter=0)):
    centres rtol 1e-5, labels equal, with and without relocate_empty."""
    x = _blobs(seed, n=500, k=3)
    key = jax.random.PRNGKey(seed)
    init, _ = jkm.kmeans(jnp.asarray(x), k, key, n_iter=0)
    want_c, want_l = jkm.kmeans(jnp.asarray(x), k, key, n_iter=12, relocate_empty=relocate_empty)
    got_c, got_l, _ = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(np.asarray(init)), 12, relocate_empty)
    _close(got_c, want_c)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))


def test_relocate_empty_reseeds_at_the_farthest_points():
    """The relocate_empty rule of jkm.kmeans (`:110-117`), read in numpy:
    from an init with two centres far from every point (both empty after
    the first assignment), tkm._lloyd reseeds them at the two points
    farthest from their own centre, in order, and every cluster ends
    non-empty; without relocation they stay empty. (jkm.kmeans takes no
    init, so its own parity is the relocate_empty case above.)"""
    x = _blobs(7, n=300, k=3)
    init = np.concatenate([x[:3], np.full((2, 3), 1e4, np.float32)])
    got_c, got_l, _ = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 1, relocate_empty=True)
    d2 = ((x[:, None, :] - init[None]) ** 2).sum(-1)
    dmin = d2.min(1)
    order = np.argsort(-dmin, kind="stable")
    np.testing.assert_array_equal(got_c[3:].numpy(), x[order[:2]])
    got_c, got_l, _ = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 10, relocate_empty=True)
    assert len(np.unique(got_l.numpy())) == 5
    _, stuck, _ = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 10, relocate_empty=False)
    assert len(np.unique(stuck.numpy())) == 3


@pytest.mark.parametrize("n_init", [1, 4])
def test_kmeans_n_init_keeps_the_lowest_inertia_run(n_init):
    """tkm.kmeans with n_init restarts returns the run of least inertia: its
    inertia is ≤ every single restart's, and labels index its centres;
    jkm.kmeans with the same n_init reaches the same inertia within 1e-4 on
    well-separated blobs (both find the blobs)."""
    rng = np.random.default_rng(11)
    mus = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0], [0, 0, 100]], np.float32)
    x = (mus[rng.integers(0, 4, 400)] + rng.normal(0, 2.0, (400, 3))).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    c, lab = tkm.kmeans(torch.from_numpy(x), 4, gen, n_iter=20, n_init=n_init)
    inertia = float(((torch.from_numpy(x) - c[lab]) ** 2).sum())
    jc, jl = jkm.kmeans(jnp.asarray(x), 4, jax.random.PRNGKey(5), n_iter=20, n_init=n_init)
    j_inertia = float(((x - np.asarray(jc)[np.asarray(jl)]) ** 2).sum())
    np.testing.assert_allclose(inertia, j_inertia, rtol=1e-4)
    if n_init > 1:
        gen = torch.Generator().manual_seed(5)
        xs = torch.from_numpy(x).expand(n_init, *x.shape)
        _, _, js = tkm._lloyd(xs, tkm._plusplus_init(xs, 4, gen), 20)
        assert inertia <= float(js.min()) * (1 + 1e-6)


def _jax_minibatch_draws(key, p, k, batch, n_steps):
    """The draws jkm.minibatch_kmeans makes per step (`:187-236`)."""
    _, _, step_key = jax.random.split(key, 3)
    bidx, perm = [], []
    for skey in jax.random.split(step_key, n_steps):
        bkey, rkey = jax.random.split(skey)
        bidx.append(np.asarray(jax.random.randint(bkey, (batch,), 0, p)))
        perm.append(np.asarray(jax.random.permutation(rkey, batch)[: min(k, batch)]))
    return torch.from_numpy(np.stack(bidx)).long(), torch.from_numpy(np.stack(perm)).long()


@pytest.mark.parametrize("ratio", [0.0, 0.01, 0.3])
def test_minibatch_kmeans_equals_jax_from_jax_draws(ratio):
    """jkm.minibatch_kmeans(init=...) ↔ tkm._minibatch_from_draws fed JAX's
    minibatch indices and reseed permutations: centres rtol 1e-5 and
    labels equal, with the reassignment off (0), at sklearn's default
    (0.01) and strong enough to fire (0.3). The init puts one centre far
    from the data, so the never-assigned gate arm fires at step 1."""
    x = _blobs(12, n=2000, k=5)
    k, batch, n_steps = 6, 64, 40
    init = np.concatenate([x[:5], np.full((1, 3), 900.0, np.float32)])
    key = jax.random.PRNGKey(9)
    want_c, want_l = jkm.minibatch_kmeans(
        jnp.asarray(x), k, key, batch_size=batch, n_steps=n_steps, init=jnp.asarray(init),
        reassignment_ratio=ratio)
    bidx, perm = _jax_minibatch_draws(key, x.shape[0], k, batch, n_steps)
    got_c = tkm._minibatch_from_draws(torch.from_numpy(x), torch.from_numpy(init), bidx, perm, ratio)
    _close(got_c, want_c)
    got_l = torch.argmin(tkm._pairwise_sqdist(torch.from_numpy(x), got_c), dim=-1)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    moved = float(np.abs(np.asarray(want_c)[5] - 900.0).max())
    assert (moved > 100) == (ratio > 0), moved


def test_minibatch_kmeans_public_draws_and_init():
    """tkm.minibatch_kmeans: deterministic for a seed, `init=` is where the
    run starts (zero steps return it), and on well-separated blobs it finds
    every blob, as jkm.minibatch_kmeans does (inertia within 2%)."""
    x = _blobs(13, n=3000, k=4, spread=2.0)
    xt = torch.from_numpy(x)
    a = tkm.minibatch_kmeans(xt, 4, torch.Generator().manual_seed(1), batch_size=256, n_steps=30)
    b = tkm.minibatch_kmeans(xt, 4, torch.Generator().manual_seed(1), batch_size=256, n_steps=30)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    init = torch.from_numpy(x[:4])
    c0, _ = tkm.minibatch_kmeans(xt, 4, init=init, n_steps=0)
    assert torch.equal(c0, init)
    jc, jl = jkm.minibatch_kmeans(jnp.asarray(x), 4, jax.random.PRNGKey(1), batch_size=256, n_steps=30)
    inertia = float(((xt - a[0][a[1]]) ** 2).sum())
    j_inertia = float(((x - np.asarray(jc)[np.asarray(jl)]) ** 2).sum())
    np.testing.assert_allclose(inertia, j_inertia, rtol=0.02)


def test_kmeans_batched_at_one_batch_equals_jax():
    """jkm.kmeans_batched ↔ tkm: at one batch entry, from JAX's per-entry
    ++ draws (kmeans_batched splits its key per entry), centres rtol 1e-5
    and labels equal; and tkm.kmeans_batched of a [2, P, D] batch equals
    tkm._lloyd of each entry from the same draws."""
    x = _blobs(14, n=500, k=3)
    key = jax.random.PRNGKey(3)
    want_c, want_l = jkm.kmeans_batched(jnp.asarray(x[None]), 3, key, n_iter=15)
    sub = jax.random.split(key, 1)[0]
    first, u = _jax_plusplus_draws(sub, x.shape[0], 3)
    init = tkm._plusplus_from_draws(torch.from_numpy(x[None]), 3, first[None], u[None])
    got_c, got_l, _ = tkm._lloyd(torch.from_numpy(x[None]), init, 15)
    _close(got_c, want_c)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))

    xb = torch.from_numpy(np.stack([x, _blobs(15, n=500, k=3)]))
    c, lab = tkm.kmeans_batched(xb, 3, torch.Generator().manual_seed(2), n_iter=15)
    first, u = tkm._plusplus_draws(torch.Generator().manual_seed(2), (2,), 500, 3)
    for i in range(2):
        ci, li, _ = tkm._lloyd(xb[i], tkm._plusplus_from_draws(xb[i], 3, first[i], u[i]), 15)
        torch.testing.assert_close(c[i], ci, rtol=1e-6, atol=1e-5)
        assert torch.equal(lab[i], li)


def _lab_gap_over_every_code(name):
    """(codes that differ, largest gap) of tlab.<name> against eager
    jlab.<name> over all 2^24 three-channel uint8 inputs, in chunks."""
    differ, worst = 0, 0
    for start in range(0, 1 << 24, 1 << 21):
        code = np.arange(start, start + (1 << 21), dtype=np.uint32)
        x = np.stack([code & 255, (code >> 8) & 255, code >> 16], -1).astype(np.uint8)
        got = getattr(tlab, name)(torch.from_numpy(x)).numpy().astype(int)
        want = np.asarray(getattr(jlab, name)(jnp.asarray(x))).astype(int)
        gap = np.abs(got - want)
        differ += int((gap > 0).sum())
        worst = max(worst, int(gap.max()))
    return differ, worst


def test_bgr2lab_equals_jax():
    """jlab.bgr2lab (eager) ↔ tlab.bgr2lab over every BGR input: exactly 9
    of the 50,331,648 codes differ, each by 1 (the cube root is a float64
    pow with XLA's float32 exponent; torch's and XLA's float32 pow of the
    gamma step still differ on a few inputs). With the exponent exactly 1/3
    the count was 198."""
    assert _lab_gap_over_every_code("bgr2lab") == (9, 1)


def test_lab2bgr_equals_jax():
    """jlab.lab2bgr (eager) ↔ tlab.lab2bgr over every Lab code: exactly 10
    of the 50,331,648 codes differ, each by 1 (pow 2.4 and pow 1/2.4 in
    float32 on both sides)."""
    assert _lab_gap_over_every_code("lab2bgr") == (10, 1)


def _flat_colour_image(h=48, w=64):
    """Four flat, well-separated colour bands of unequal widths."""
    img = np.zeros((h, w, 3), np.uint8)
    for (x0, x1), c in zip([(0, 10), (10, 26), (26, 45), (45, 64)],
                           [(20, 40, 200), (200, 60, 30), (40, 220, 60), (230, 230, 230)]):
        img[:, x0:x1] = c
    return img


@pytest.mark.parametrize("method", ["lloyd", "minibatch"])
def test_quantize_colors_equals_jax_on_flat_colours(method):
    """jquant ↔ tquant on four flat colour bands at k=4, both methods: the
    ++ seeding must pick each colour once whatever the draws, so the
    repainted images are bitwise equal."""
    img = _flat_colour_image()
    want = np.asarray(jquant(jnp.asarray(img), 4, jax.random.PRNGKey(0), method=method))
    got = tquant(torch.from_numpy(img), 4, torch.Generator().manual_seed(0), method=method).numpy()
    np.testing.assert_array_equal(got, want)


def test_quantize_lloyd_repaint_equals_jax_from_jax_draws():
    """jquant(method='lloyd') ↔ the port's steps fed JAX's draws (the
    subsample's indices, the ++ draws of its kmeans): tlab.bgr2lab, then
    tkm._lloyd on the subsample, the full assignment and _repaint. At most
    0.1% of pixels differ (a LAB code off by one moves a pixel's nearest
    centre only at a tie), and by at most 2 per channel."""
    img = np.random.default_rng(3).integers(0, 256, (40, 60, 3), dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    want = np.asarray(jquant(jnp.asarray(img), 5, key, sample=512))
    k1, k2 = jax.random.split(key)
    n = img.shape[0] * img.shape[1]
    idx = np.asarray(jax.random.choice(k1, n, shape=(512,), replace=False))
    jl = np.asarray(jlab.bgr2lab(jnp.asarray(img))).reshape(-1, 3).astype(np.float32)
    init, _ = jkm.kmeans(jnp.asarray(jl[idx]), 5, k2, n_iter=0)
    lab = tlab.bgr2lab(torch.from_numpy(img)).reshape(-1, 3).float()
    c, _, _ = tkm._lloyd(lab[torch.from_numpy(idx)], torch.from_numpy(np.asarray(init)), 30)
    labels = torch.argmin(tkm._pairwise_sqdist(lab, c), dim=-1)
    got = _repaint(c, labels, img.shape[:2]).numpy().astype(int)
    gap = np.abs(got - want.astype(int))
    assert (gap.max(-1) > 0).mean() <= 1e-3 and gap.max() <= 2, ((gap.max(-1) > 0).mean(), gap.max())


def test_quantize_colors_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown method"):
        tquant(torch.zeros(4, 4, 3, dtype=torch.uint8), 2, method="kmeans++")
