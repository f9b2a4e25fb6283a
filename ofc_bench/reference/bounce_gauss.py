"""Plain reference of the bounce-feature pipeline with OpenCV's Gaussian
window (OPTFLOW_FARNEBACK_GAUSSIAN), in plain PyTorch.

The pipeline of `bounce.py` (gray, the Gaussian pyramid, polynomial
expansion, the warp with the 'fast' reach masks, the HSV render, grid
pooling and the k=1 dominant hue), whose helpers it imports, with the box
solve replaced by the Gaussian-weighted one, written here from OpenCV's
FarnebackUpdateFlow_GaussianBlur as the port's plain version writes it:
the window's weights are the float64 Gaussian of sigma 0.3·(winsize // 2),
normalised, then rounded to float32; the five planes of M are filtered
vertically then horizontally with a replicate border, each pass summing
centre first and then each pair of taps at distance d; then the 2×2 solve
with det + 1e-3. It imports nothing of the port or of JAX.

Every float step runs in `dtype`: float32 is the reference, and bfloat16 is
the control.
"""

from __future__ import annotations

import numpy as np
import torch

from ofc_bench.reference.bounce import (
    _REACH,
    _pad_axis,
    bgr2gray,
    f32,
    gaussian_blur,
    grid_tables,
    poly_expansion,
    pyramid_plan,
    render_flow,
    resize_linear,
    update_matrices,
)


def window_weights(winsize: int) -> list[float]:
    """The float32 weights at distance 0 .. winsize // 2 of the Gaussian
    window, as Python floats."""
    r = winsize // 2
    sigma = r * 0.3
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = k / k.sum()
    return [f32(k[r - d]) for d in range(r + 1)]


def _gauss_pass(x: torch.Tensor, weights: list[float], axis: int) -> torch.Tensor:
    """One axis of the window, replicate border: k0·x + Σ kd·(x₋d + x₊d)."""
    r = len(weights) - 1
    n = x.shape[axis]
    xp = _pad_axis(x, axis, r, "edge")
    acc = weights[0] * xp.narrow(axis, r, n)
    for d in range(1, r + 1):
        acc = acc + weights[d] * (xp.narrow(axis, r - d, n) + xp.narrow(axis, r + d, n))
    return acc


def gauss_solve(m: torch.Tensor, winsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Gaussian-weighted sums of M [B, 5, H, W] over winsize × winsize
    and the 2×2 solve with det + 1e-3 → (fx, fy) [B, H, W]."""
    weights = window_weights(winsize)
    s = _gauss_pass(_gauss_pass(m, weights, 2), weights, 3)
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + f32(1e-3))
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def farneback_flow(prev: torch.Tensor, nxt: torch.Tensor, fb: dict, dt: torch.dtype) -> torch.Tensor:
    """Dense flow of gray pairs [B, H, W] uint8 → [B, H, W, 2] in `dt`, the
    Gaussian window in every iteration of every level."""
    h, w = prev.shape[-2:]
    reach = _REACH[fb["warp_mode"]]
    fx = fy = None
    for _, h_k, w_k, sigma in pyramid_plan(h, w, fb["pyr_scale"], fb["levels"]):
        ksize = max(int(np.rint(sigma * 5)) | 1, 3)
        r0, r1 = (poly_expansion(resize_linear(gaussian_blur(img.to(dt), ksize, sigma), (h_k, w_k)),
                                 fb["poly_n"], fb["poly_sigma"]) for img in (prev, nxt))
        if fx is None:
            fx = torch.zeros((r0.shape[0], h_k, w_k), dtype=dt, device=r0.device)
            fy = torch.zeros_like(fx)
        else:
            up = resize_linear(torch.stack([fx, fy], dim=1), (h_k, w_k)) * f32(1.0 / fb["pyr_scale"])
            fx, fy = up[:, 0].contiguous(), up[:, 1].contiguous()
        for _ in range(fb["iterations"]):
            fx, fy = gauss_solve(update_matrices(r0, r1, fx, fy, reach), fb["winsize"])
    return torch.stack([fx, fy], dim=-1)


@torch.inference_mode()
def clip_tables(frames: np.ndarray, cfg: dict, device: str | torch.device,
                dtype: torch.dtype = torch.float32, emit_flow_bgr: bool = False) -> dict[str, np.ndarray]:
    """Tables of every pair of a clip [N, H, W, 3] uint8 BGR, computed on
    `device` in blocks of `cfg['chunk']` pairs (the last padded with its
    final frame): hue_table, rgb_hue_table, centroids, mean_magnitude (and
    flow_bgr when asked). `cfg['farneback']` must ask for the Gaussian
    window."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fb, grid, chunk = cfg["farneback"], cfg["grid"], cfg["chunk"]
    if not fb.get("gaussian_win"):
        raise ValueError("bounce_gauss is the reference of the Gaussian window; use bounce for the box")
    n_pairs = frames.shape[0] - 1
    parts: dict[str, list[np.ndarray]] = {}
    for start in range(0, n_pairs, chunk):
        block = frames[start : start + chunk + 1]
        n_real = block.shape[0] - 1
        block = np.concatenate([block, np.repeat(block[-1:], chunk + 1 - block.shape[0], axis=0)])
        gray = bgr2gray(torch.from_numpy(block).to(device))
        flow = farneback_flow(gray[:-1], gray[1:], fb, dtype)
        mag, flow_bgr = render_flow(flow)
        centroids, hue, rgb_hue = grid_tables(flow_bgr, grid["rows"], grid["cols"], cfg["rb_swap"])
        out = {"hue_table": hue, "rgb_hue_table": rgb_hue, "centroids": centroids,
               "mean_magnitude": mag.to(torch.float32).mean(dim=(-2, -1))}
        if emit_flow_bgr:
            out["flow_bgr"] = flow_bgr
        for k, v in out.items():
            parts.setdefault(k, []).append(v[:n_real].cpu().numpy())
        del gray, flow, mag, flow_bgr, out
    return {k: np.concatenate(v) for k, v in parts.items()}
