"""Carrying state across from the JAX package.

The bounce-feature path has no learned weights: its state is configuration
and constant tables. `from_jax_config` maps the JAX package's frozen config
dataclasses field by field onto the port's (it takes the objects and
imports nothing from JAX); `constant_tables` returns the port's copies of
the numpy tables the JAX modules build, so a test can hold each one
`array_equal` to the original.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from opticalflowclustering_tpu_torch.features.grid import GridParams
from opticalflowclustering_tpu_torch.flow.farneback import (
    _BORDER_SCALE,
    FarnebackParams,
    _border_taper,
    _poly_exp_consts,
    pyramid_plan,
)
from opticalflowclustering_tpu_torch.ops.colorspace import _hsv_div_tables
from opticalflowclustering_tpu_torch.ops.filters import gaussian_kernel
from opticalflowclustering_tpu_torch.ops.resize import _linear_weight_matrix
from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig

# JAX-only fields with no counterpart in the port: the legacy 'select' warp's
# radius (the port has no 'select' mode; FarnebackParams rejects it).
_DROPPED = {"FarnebackParams": {"warp_radius"}}


def _carry(cfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    src = {f.name for f in dataclasses.fields(cfg)}
    unknown = src - names - _DROPPED.get(cls.__name__, set())
    if unknown:
        raise ValueError(f"{type(cfg).__name__} fields with no port: {sorted(unknown)}")
    return {n: getattr(cfg, n) for n in names & src}


def from_jax_config(cfg):
    """The port's PipelineConfig / FarnebackParams / GridParams for the JAX
    object of the same name, field by field."""
    kind = type(cfg).__name__
    if kind == "PipelineConfig":
        kw = _carry(cfg, PipelineConfig)
        kw["grid"] = from_jax_config(cfg.grid)
        kw["flow"] = from_jax_config(cfg.flow)
        return PipelineConfig(**kw)
    if kind == "FarnebackParams":
        return FarnebackParams(**_carry(cfg, FarnebackParams))
    if kind == "GridParams":
        return GridParams(**_carry(cfg, GridParams))
    raise TypeError(f"no port for config type {kind}")


def constant_tables(
    cfg: PipelineConfig = PipelineConfig(), height: int = 720, width: int = 1280
) -> dict[str, np.ndarray]:
    """The numpy tables the flow and colour stages use for `cfg` at
    `height`×`width`, keyed by the JAX function that builds them."""
    p = cfg.flow
    g, xg, xxg, *inv = _poly_exp_consts(p.poly_n, p.poly_sigma)
    sdiv, hdiv = _hsv_div_tables()
    tables = {
        "poly_exp_consts.g": g,
        "poly_exp_consts.xg": xg,
        "poly_exp_consts.xxg": xxg,
        "poly_exp_consts.inv_gram": np.array(inv),
        "border_scale": _BORDER_SCALE,
        "pyramid_plan": np.array(pyramid_plan(height, width, p)),
        "hsv_div_tables.sdiv": sdiv,
        "hsv_div_tables.hdiv": hdiv,
    }
    prev = None
    for k, h_k, w_k, sigma in pyramid_plan(height, width, p):
        smooth_sz = max(int(np.rint(sigma * 5)) | 1, 3)
        tables[f"gaussian_kernel.level{k}"] = gaussian_kernel(smooth_sz, sigma)
        tables[f"linear_weight_matrix.level{k}.h"] = _linear_weight_matrix(h_k, height)
        tables[f"linear_weight_matrix.level{k}.w"] = _linear_weight_matrix(w_k, width)
        if prev is not None:
            tables[f"linear_weight_matrix.flow{k}.h"] = _linear_weight_matrix(h_k, prev[0])
            tables[f"linear_weight_matrix.flow{k}.w"] = _linear_weight_matrix(w_k, prev[1])
        tables[f"border_taper.level{k}"] = _border_taper(h_k, w_k)
        prev = (h_k, w_k)
    return tables
