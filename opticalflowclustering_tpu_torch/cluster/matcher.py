"""Sliding-window signature matching, the bounce classifier, and the
whole-matrix vector distances (port of
`opticalflowclustering_tpu/cluster/matcher.py`; reference
`findCosineDifferentVectors.py:52-66`, `computeVectorDistance.py`)."""

from __future__ import annotations

import torch


def sliding_cosine_similarity(
    signature: torch.Tensor, series: torch.Tensor
) -> torch.Tensor:
    """Cosine similarity of `signature` [L] against every length-L window
    of `series` [N] → [N-L+1]; zero-norm windows (or signature) score 0."""
    sig = signature.to(torch.float32)
    ser = series.to(torch.float32)
    windows = ser.unfold(0, sig.shape[0], 1)  # [N-L+1, L]
    dots = windows @ sig
    sig_norm = torch.sqrt(torch.sum(sig * sig))
    win_norm = torch.sqrt(torch.sum(windows * windows, dim=-1))
    denom = sig_norm * win_norm
    return torch.where(denom > 0, dots / denom, 0.0)


def match_signature(
    signature: torch.Tensor, series: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(max_similarity, max_frame); the *last* window attaining the
    maximum wins, as in the reference (`findCosineDifferentVectors.py:57-61`)."""
    sims = sliding_cosine_similarity(signature, series)
    max_sim = sims.max()
    hits = torch.nonzero(sims == max_sim).flatten()
    return max_sim, hits[-1]


def cosine_similarity_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sklearn.metrics.pairwise.cosine_similarity for [n,d]×[m,d] → [n,m] in
    float32 (`computeVectorDistance.py:3,26`)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp_min(1e-30)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp_min(1e-30)
    return an @ bn.T


def rowwise_euclidean_sum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ_i ‖a_i − b_i‖ over the common prefix of rows, in float32
    (`computeVectorDistance.py:32-38`)."""
    m = min(a.shape[0], b.shape[0])
    d = a[:m].to(torch.float32) - b[:m].to(torch.float32)
    return torch.sqrt(torch.sum(d * d, dim=-1)).sum()
