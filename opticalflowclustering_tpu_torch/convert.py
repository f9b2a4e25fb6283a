"""Carrying state across from the JAX package.

The bounce-feature path has no learned weights: its state is configuration
and constant tables. `from_jax_config` maps the JAX package's frozen config
dataclasses field by field onto the port's (it takes the objects and
imports nothing from JAX); `constant_tables` returns the port's copies of
the numpy tables the JAX modules build, so a test can hold each one
`array_equal` to the original.

The models carry learned parameters: `from_flax_params` turns the JAX
package's flax parameters of FlowCellNet, SmallCNN or BounceClassifier into
the port's state dict, and `to_flax_params` turns a port model back into
the flat keystr-keyed dict the JAX package saves.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Mapping

import numpy as np
import torch

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

def _carry(cfg, cls):
    names = {f.name for f in dataclasses.fields(cls)}
    src = {f.name for f in dataclasses.fields(cfg)}
    unknown = src - names
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


# ---------------------------------------------------------------------------
# learned parameters: flax pytrees ↔ the port's state dicts
# ---------------------------------------------------------------------------

# Layers of each model, in flax's auto-naming (Conv_i / Dense_i); the port's
# models hold them as `convs.i` and `dense.i`.
_FLAX_LAYERS = {
    "FlowCellNet": {"Conv": 6, "Dense": 2},
    "SmallCNN": {"Conv": 3, "Dense": 2},
    "BounceClassifier": {"Conv": 0, "Dense": 3},
}
_PORT_PREFIX = {"Conv": "convs", "Dense": "dense"}
_KEYSTR = re.compile(r"\['([^']*)'\]")


def _flax_leaves(params) -> dict[tuple[str, ...], np.ndarray]:
    """(path, array) of every leaf of a flax params pytree (nested mappings)
    or of a flat mapping keyed by `jax.tree_util.keystr` (a loaded npz)."""
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (tuple(_KEYSTR.findall(k)) or (k,)))
        else:
            out[path] = np.asarray(node)

    walk(params, ())
    return out


def from_flax_params(model_name: str, flat_npz_or_pytree) -> dict[str, torch.Tensor]:
    """The port's state dict for `model_name` ("FlowCellNet", "SmallCNN",
    "BounceClassifier") from the JAX package's parameters of that model: a
    flax pytree, or a flat mapping keyed like `['params']['Conv_0']['kernel']`
    (the npz the JAX package saves). Conv kernels HWIO → OIHW, Dense kernels
    [in, out] → Linear weights [out, in], biases as they are."""
    if model_name not in _FLAX_LAYERS:
        raise ValueError(f"no flax layout for model {model_name!r}")
    want = {(kind, i) for kind, n in _FLAX_LAYERS[model_name].items() for i in range(n)}
    state = {}
    for path, arr in _flax_leaves(flat_npz_or_pytree).items():
        path = path[1:] if path[:1] == ("params",) else path
        layer, leaf = path
        kind, _, idx = layer.partition("_")
        if (kind, int(idx or -1)) not in want or leaf not in ("kernel", "bias"):
            raise ValueError(f"{model_name} has no flax parameter {path}")
        if leaf == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        state[f"{_PORT_PREFIX[kind]}.{idx}.{'weight' if leaf == 'kernel' else 'bias'}"] = (
            torch.from_numpy(np.array(arr, dtype=np.float32, order="C")))
    if len(state) != 2 * len(want):
        raise ValueError(f"{model_name}: {len(state)} parameters, {2 * len(want)} expected")
    return state


def to_flax_params(model) -> dict[str, np.ndarray]:
    """The inverse of from_flax_params: the port's model → a flat dict keyed
    like `jax.tree_util.keystr` of the flax params (`['params']['Dense_0']
    ['kernel']`), in flax's sorted key order, as the JAX package saves it."""
    inv = {v: k for k, v in _PORT_PREFIX.items()}
    out = {}
    for name, t in model.state_dict().items():
        prefix, idx, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        if leaf == "weight":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        key = f"['params']['{inv[prefix]}_{idx}']['{'kernel' if leaf == 'weight' else 'bias'}']"
        out[key] = np.ascontiguousarray(arr)
    return dict(sorted(out.items()))
