"""The learned bounce classifier (port of
`opticalflowclustering_tpu/models/bounce_classifier.py`): the trainable
upgrade of the reference's cosine-template matcher
(`findCosineDifferentVectors.py:52-66`).

An MLP over hue feature vectors (scalar-hue windows or grid-hue rows). Hues
are circular (uint8 degrees/2 in [0, 180)), so each is embedded as the
(sin, cos) of its angle. Training is AdamW with optax's defaults, which are
not torch's: weight decay 1e-4 (torch: 1e-2), applied to the biases too.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opticalflowclustering_tpu_torch.models.layers import flax_init_
from opticalflowclustering_tpu_torch.runtime import f32, resolve_device


class BounceClassifier(nn.Module):
    """[B, D] hue values → logits [B]: (sin, cos) embedding of each hue's
    angle, two `hidden`-wide Dense layers with ReLU, one Dense to 1."""

    def __init__(self, feature_dim: int, hidden: int = 64):
        super().__init__()
        self.dense = nn.ModuleList(
            [nn.Linear(2 * feature_dim, hidden), nn.Linear(hidden, hidden), nn.Linear(hidden, 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        theta = x.to(torch.float32) * f32(2.0 * math.pi / 180.0)
        h = torch.cat([torch.sin(theta), torch.cos(theta)], dim=-1)
        h = F.relu(self.dense[0](h))
        h = F.relu(self.dense[1](h))
        return self.dense[2](h)[..., 0]


def init_classifier(
    generator: torch.Generator | None,
    feature_dim: int,
    hidden: int = 64,
    device: str | torch.device = "cuda",
) -> BounceClassifier:
    """A BounceClassifier on `device`, initialised flax's way (lecun_normal
    weights, zero biases) from `generator` (default: seed 0)."""
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    return flax_init_(BounceClassifier(feature_dim, hidden), gen).to(resolve_device(device))


def adamw(params, lr: float) -> torch.optim.AdamW:
    """optax.adamw(lr) in torch: betas (0.9, 0.999), eps 1e-8 and weight
    decay 1e-4 on every parameter, biases included."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_train_step(model: BounceClassifier, optimizer: torch.optim.Optimizer):
    """A train step `step(x, y) → loss`: the mean sigmoid binary cross entropy
    of model(x) against y, its gradient, one optimizer update. The model
    and the optimizer hold the parameters and the optimizer state."""

    def train_step(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        loss = F.binary_cross_entropy_with_logits(model(x), y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return train_step


def _fit(model: BounceClassifier, x: torch.Tensor, y: torch.Tensor, steps: int, lr: float) -> float:
    """`steps` full-batch AdamW steps of the model on (x, y); the last loss."""
    step = make_train_step(model, adamw(model.parameters(), lr))
    loss = None
    for _ in range(steps):
        loss = step(x, y)
    return float(loss)


def train_on_hue_windows(
    windows,
    labels,
    hidden: int = 64,
    steps: int = 200,
    lr: float = 1e-3,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> tuple[BounceClassifier, float]:
    """Single-device trainer: hue windows [B, D] and binary labels [B] →
    (trained model on `device`, final loss). The initialisation comes from a
    generator seeded `seed`."""
    dev = resolve_device(device)
    x = torch.as_tensor(windows).to(dev, torch.float32)
    y = torch.as_tensor(labels).to(dev, torch.float32)
    model = init_classifier(torch.Generator().manual_seed(seed), x.shape[-1], hidden, dev)
    return model, _fit(model, x, y, steps, lr)


def hue_windows_from_series(series, window: int) -> np.ndarray:
    """[N] hue series → [N-window+1, window] sliding windows (feature rows
    for training; mirrors the matcher's windowing)."""
    series = np.asarray(series, dtype=np.float32)
    n = len(series) - window + 1
    idx = np.arange(n)[:, None] + np.arange(window)[None, :]
    return series[idx]
