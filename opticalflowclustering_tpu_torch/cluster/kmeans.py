"""Batched Lloyd k-means and MiniBatchKMeans (port of
`opticalflowclustering_tpu/cluster/kmeans.py`).

One call clusters every cell of every frame: assignment is a [P, k]
distance matmul, the update a one-hot matmul, and the Lloyd loop runs over a
leading batch axis, so `kmeans_batched` over [B, P, D] is one program of
batched matmuls on the card.

Each public function draws its random numbers with a `torch.Generator` (on
the CPU, so a seed gives the same draws on every device) and hands them, as
tensors, to an inner function that does the arithmetic: the ++ candidates
(`_plusplus_draws`), the minibatch indices and the reseed permutation
(`_minibatch_draws`). A test can feed the inner functions the draws JAX made,
since JAX's PRNG cannot be reproduced in torch.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from opticalflowclustering_tpu_torch.runtime import f32


def _pairwise_sqdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[..., P, D], [..., K, D] → [..., P, K] squared distances via a matmul."""
    x2 = (x * x).sum(dim=-1, keepdim=True)
    c2 = (c * c).sum(dim=-1)
    xc = torch.matmul(x, c.transpose(-1, -2))
    return x2 - 2.0 * xc + c2[..., None, :]


def _n_local_trials(k: int) -> int:
    return 2 + int(math.log(max(k, 2)))


def _default_generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _plusplus_draws(
    generator: torch.Generator, batch: tuple[int, ...], p: int, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """The draws of k-means++ seeding: the first centre's index [*batch] and
    the uniforms [*batch, k-1, L] that pick each later centre's L candidates
    (JAX: `randint`, then one `uniform` per `jax.random.choice`)."""
    first = torch.randint(0, p, batch, generator=generator)
    u = torch.rand(batch + (k - 1, _n_local_trials(k)), generator=generator)
    return first, u


def _plusplus_from_draws(
    x: torch.Tensor, k: int, first: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """k-means++ seeding with sklearn's GREEDY local trials over x [..., P, D]:
    each new centre is the one of `2 + ⌊ln k⌋` d²-sampled candidates that
    minimises the total potential Σ min-d². Candidates are drawn by inverse
    CDF from the uniforms `u` [..., k-1, L], as `jax.random.choice(p=...)`
    does: searchsorted(cumsum(p), cumsum(p)[-1] · (1 − u)).
    Returns centres [..., k, D]."""
    p = x.shape[-2]
    first = first.to(x.device)
    u = u.to(x.device)
    c0 = torch.gather(x, -2, first[..., None, None].expand(first.shape + (1, x.shape[-1])))
    centers = [c0[..., 0, :]]
    closest = ((x - c0) ** 2).sum(dim=-1)  # [..., P]
    for i in range(1, k):
        pot = torch.clamp(closest.sum(dim=-1, keepdim=True), min=1e-12)
        probs = torch.clamp(closest, min=0.0) / pot
        cuml = torch.cumsum(probs, dim=-1)
        r = cuml[..., -1:] * (1 - u[..., i - 1, :])
        cand = torch.searchsorted(cuml.contiguous(), r.contiguous()).clamp(max=p - 1)  # [..., L]
        xc = torch.gather(x, -2, cand[..., None].expand(cand.shape + (x.shape[-1],)))  # [..., L, D]
        new_min = torch.minimum(closest[..., None], _pairwise_sqdist(x, xc))  # [..., P, L]
        b = torch.argmin(new_min.sum(dim=-2), dim=-1)  # [...]
        centers.append(torch.gather(xc, -2, b[..., None, None].expand(b.shape + (1, x.shape[-1])))[..., 0, :])
        closest = torch.gather(new_min, -1, b[..., None, None].expand(b.shape + (p, 1)))[..., 0]
    return torch.stack(centers, dim=-2)


def _plusplus_init(x: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ centres [..., k, D] of x [..., P, D], drawn with `generator`."""
    first, u = _plusplus_draws(generator, tuple(x.shape[:-2]), x.shape[-2], k)
    return _plusplus_from_draws(x, k, first, u)


def _lloyd(
    x: torch.Tensor, centers: torch.Tensor, n_iter: int, relocate_empty: bool = False
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`n_iter` Lloyd steps over x [..., P, D] from centres [..., k, D] →
    (centres, labels [..., P], inertia [...]). Empty clusters keep their
    centre, or with `relocate_empty` are reseeded at the points farthest
    from their own centre (sklearn `_relocate_empty_clusters`)."""
    p, k = x.shape[-2], centers.shape[-2]
    for _ in range(n_iter):
        d2 = _pairwise_sqdist(x, centers)
        labels = torch.argmin(d2, dim=-1)
        onehot = F.one_hot(labels, k).to(torch.float32)  # [..., P, k]
        counts = onehot.sum(dim=-2)  # [..., k]
        sums = torch.matmul(onehot.transpose(-1, -2), x)
        new = sums / torch.clamp(counts[..., None], min=1.0)
        new = torch.where(counts[..., None] > 0, new, centers)
        if relocate_empty:
            dmin = torch.gather(d2, -1, labels[..., None])[..., 0]
            order = torch.argsort(-dmin, dim=-1, stable=True)
            rank = torch.cumsum((counts == 0).to(torch.int64), dim=-1) - 1  # slot among empties
            pick = torch.gather(order, -1, rank.clamp(0, p - 1))  # [..., k]
            cand = torch.gather(x, -2, pick[..., None].expand(pick.shape + (x.shape[-1],)))
            new = torch.where((counts == 0)[..., None], cand, new)
        centers = new
    d2 = _pairwise_sqdist(x, centers)
    return centers, torch.argmin(d2, dim=-1), d2.amin(dim=-1).sum(dim=-1)


def kmeans(
    points: torch.Tensor,
    k: int,
    generator: torch.Generator | None = None,
    n_iter: int = 30,
    relocate_empty: bool = False,
    n_init: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means over [P, D] points → (centres [k, D], labels [P]) on the
    points' device. Deterministic given `generator` (default: seed 0).
    `n_init > 1` runs that many k-means++ restarts as one batch and keeps the
    lowest-inertia run (the first of ties)."""
    x = torch.as_tensor(points).to(torch.float32)
    gen = _default_generator(generator)
    if n_init == 1:
        centers, labels, _ = _lloyd(x, _plusplus_init(x, k, gen), n_iter, relocate_empty)
        return centers, labels
    xs = x.expand((n_init,) + x.shape)
    cs, ls, js = _lloyd(xs, _plusplus_init(xs, k, gen), n_iter, relocate_empty)
    b = int(torch.argmin(js))
    return cs[b], ls[b]


def _minibatch_draws(
    generator: torch.Generator, p: int, k: int, batch_size: int, n_steps: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per step: the with-replacement minibatch indices [n_steps, batch] and
    the first min(k, batch) entries of a permutation of the batch
    [n_steps, min(k, batch)] that reseed starved centres."""
    bidx = torch.randint(0, p, (n_steps, batch_size), generator=generator)
    perm = torch.argsort(torch.rand(n_steps, batch_size, generator=generator), dim=-1)
    return bidx, perm[:, : min(k, batch_size)]


def _minibatch_from_draws(
    x: torch.Tensor,
    centers: torch.Tensor,
    bidx: torch.Tensor,
    perm: torch.Tensor,
    reassignment_ratio: float = 0.01,
) -> torch.Tensor:
    """sklearn's `_mini_batch_step` over x [P, D] from centres [k, D], one
    step per row of the draws `bidx` [n_steps, batch] and `perm`
    [n_steps, min(k, batch)]. Returns the centres.

    Each touched centre takes the counts-weighted update
    c ← (w·c + Σ_batch x) / (w + n) with its weight carried, w ← w + n. When
    `reassignment_ratio > 0`, every 10·k processed samples, or while any
    pre-step weight is 0, centres whose weight is below ratio · max weight
    (at most ⌊batch/2⌋ of them, lowest weights first) are reseeded at the
    batch points perm names, and their weights set to the least weight of
    the centres that were not reseeded."""
    k = centers.shape[0]
    batch_size = bidx.shape[1]
    max_reassign = batch_size // 2
    bidx, perm = bidx.to(x.device), perm.to(x.device)
    wsum = torch.zeros(k, dtype=torch.float32, device=x.device)
    since = torch.zeros((), dtype=torch.int64, device=x.device)
    for s in range(bidx.shape[0]):
        xb = x[bidx[s]]
        d2 = _pairwise_sqdist(xb, centers)
        labels = torch.argmin(d2, dim=-1)
        onehot = F.one_hot(labels, k).to(torch.float32)
        nc = onehot.sum(dim=0)
        sums = onehot.T @ xb
        new_w = wsum + nc
        new_c = (wsum[:, None] * centers + sums) / torch.clamp(new_w[:, None], min=1.0)
        new_c = torch.where(nc[:, None] > 0, new_c, centers)
        since += batch_size
        if reassignment_ratio > 0:
            # sklearn's `_random_reassign` gate: every 10·k samples, or while
            # a centre has never been assigned (the PRE-step weights).
            gate = torch.any(wsum == 0) | (since >= 10 * k)
            since = torch.where(gate, 0, since)
            starved = new_w < f32(reassignment_ratio) * new_w.max()
            rank = torch.argsort(torch.argsort(new_w, stable=True), stable=True)
            starved = starved & (rank < max_reassign) & gate
            slot = torch.clamp(torch.cumsum(starved.to(torch.int64), 0) - 1, 0, perm.shape[1] - 1)
            seeds = xb[perm[s][slot]]
            w_floor = torch.where(starved, torch.inf, new_w).min()
            new_c = torch.where(starved[:, None], seeds, new_c)
            new_w = torch.where(starved, w_floor, new_w)
        centers, wsum = new_c, new_w
    return centers


def minibatch_kmeans(
    points: torch.Tensor,
    k: int,
    generator: torch.Generator | None = None,
    batch_size: int = 1024,
    n_steps: int = 100,
    init_size: int = 3072,
    init: torch.Tensor | None = None,
    reassignment_ratio: float = 0.01,
) -> tuple[torch.Tensor, torch.Tensor]:
    """sklearn-semantics MiniBatchKMeans (`color-quantization/quant.py:
    18-19`) over [P, D] points → (centres [k, D], labels [P]) on the points'
    device. Centres start at `init` (sklearn's ``init=<array>``) or at the
    k-means++ seeding of a without-replacement subsample of `init_size`
    points; `reassignment_ratio=0` turns the reassignment off. Draws come
    from `generator` (default: seed 0)."""
    x = torch.as_tensor(points).to(torch.float32)
    gen = _default_generator(generator)
    p = x.shape[0]
    if init is not None:
        centers0 = torch.as_tensor(init).to(x.device, torch.float32)
    else:
        idx = torch.randperm(p, generator=gen)[: min(init_size, p)].to(x.device)
        centers0 = _plusplus_init(x[idx], k, gen)
    bidx, perm = _minibatch_draws(gen, p, k, batch_size, n_steps)
    centers = _minibatch_from_draws(x, centers0, bidx, perm, reassignment_ratio)
    return centers, torch.argmin(_pairwise_sqdist(x, centers), dim=-1)


def kmeans_batched(
    points: torch.Tensor,
    k: int,
    generator: torch.Generator | None = None,
    n_iter: int = 30,
) -> tuple[torch.Tensor, torch.Tensor]:
    """kmeans over one leading batch axis, as one batched program: [B, P, D]
    → (centres [B, k, D], labels [B, P]). Each batch entry takes its own ++
    draws. This replaces the reference's 350-KMeans-calls-per-frame loop for
    k>1."""
    x = torch.as_tensor(points).to(torch.float32)
    centers, labels, _ = _lloyd(x, _plusplus_init(x, k, _default_generator(generator)), n_iter)
    return centers, labels
