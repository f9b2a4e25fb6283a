"""Reinhard LAB colour transfer (port of
`opticalflowclustering_tpu/extras/color_transfer.py`; the reference is
`color-transfer/color_transfer.py:5-42`).

LAB channel means and population standard deviations, scale by the std
ratio, clip, back to BGR, with the reference's std-ratio direction
(`lStdTar / lStdSrc`, the inverse of Reinhard's paper; output parity needs
it). It inherits `ops.lab`'s gap to the JAX package: a few bgr2lab codes
round the other way."""

from __future__ import annotations

import torch

from opticalflowclustering_tpu_torch.ops.lab import bgr2lab, lab2bgr
from opticalflowclustering_tpu_torch.runtime import on_device


def color_transfer(source_bgr, target_bgr, device: str | torch.device = "cuda") -> torch.Tensor:
    """Transfer `source`'s colour statistics onto `target` ([H, W, 3] uint8)
    on `device` → [H, W, 3] uint8 tensor there."""
    src = bgr2lab(on_device(source_bgr, device)).to(torch.float32)
    tar = bgr2lab(on_device(target_bgr, device)).to(torch.float32)
    src_mean = src.mean(dim=(-3, -2))
    src_std = src.std(dim=(-3, -2), correction=0)  # jnp.std: the population std
    tar_mean = tar.mean(dim=(-3, -2))
    tar_std = tar.std(dim=(-3, -2), correction=0)
    out = (tar - tar_mean) * (tar_std / src_std) + src_mean
    # clip, then truncate to uint8 as astype does
    return lab2bgr(torch.clamp(out, 0, 255).to(torch.uint8))
