"""Layers shared by the port's models: flax's 'SAME' convolution and flax's
default initialisation.

flax `nn.Conv` pads 'SAME' the XLA way: for input size n, stride s and
kernel k the output has ⌈n/s⌉ samples, the total padding is
max((⌈n/s⌉ − 1)·s + k − n, 0), and the low side takes total // 2, the high
side the rest. A stride-2 3×3 conv on 50 samples needs a total of 1 and pads
(0, 1); `nn.Conv2d(padding=1)` would pad (1, 1) and give other numbers.
`SameConv2d` computes the padding of each call from its input's size and
pads explicitly.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's lecun_normal draws a normal truncated at ±2 standard deviations and
# divides its scale by this constant, the standard deviation of the
# standard normal truncated to [-2, 2].
_TRUNC_STD = 0.87962566103423978


def same_pads(n: int, stride: int, k: int) -> tuple[int, int]:
    """(low, high) padding of XLA's 'SAME' for one spatial axis."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """nn.Conv2d over NCHW with flax's 'SAME' padding, computed per call."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3, stride: int = 1):
        super().__init__(in_ch, out_ch, kernel, stride=stride, padding=0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_pads(x.shape[-2], sh, kh)
        left, right = same_pads(x.shape[-1], sw, kw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default initialisation of every Conv2d and Linear of `model`,
    drawn from `generator`: lecun_normal weights (a normal of variance
    1/fan_in truncated at ±2σ), zero biases. The draws are torch's, so the
    values are not JAX's."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            m.weight.copy_(w)
            m.bias.zero_()
    return model
