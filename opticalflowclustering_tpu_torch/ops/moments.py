"""Shape descriptors: image moments, Hu invariants, Zernike moments (port of
`opticalflowclustering_tpu/ops/moments.py`).

Reference call sites: the Hu moments demo
(`opencv-shape-descriptors/humoments.py:7`) and the Pokédex shape index
(`Pokedex/pyimagesearch/zernikemoments.py:10-12`, mahotas
`zernike_moments(image, radius, degree=8)`). Raw and central moments are
weighted reductions against coordinate powers; Zernike sums the image
against each radial polynomial times its angular phase over the disc.
Integer powers are repeated multiplications in the order of JAX's
`integer_pow` (square-and-multiply), not a library pow, which rounds
otherwise.
"""

from __future__ import annotations

import functools
import math

import torch

from opticalflowclustering_tpu_torch.runtime import f32


def _ipow(x: torch.Tensor, p: int) -> torch.Tensor:
    """x**p for an integer p >= 0 as lax.integer_pow computes it."""
    if p == 0:
        return torch.ones_like(x)
    acc = None
    while p > 0:
        if p & 1:
            acc = x if acc is None else acc * x
        p >>= 1
        if p > 0:
            x = x * x
    return acc


def moments(img: torch.Tensor) -> dict[str, torch.Tensor]:
    """cv2.moments of a (grayscale) [..., H, W] image: raw m*, central mu*,
    normalized nu*, OpenCV's keys. float64 input stays float64, any other
    is taken as float32."""
    f = img.to(torch.float64 if img.dtype == torch.float64 else torch.float32)
    h, w = f.shape[-2], f.shape[-1]
    ys = torch.arange(h, dtype=f.dtype, device=f.device)[:, None]
    xs = torch.arange(w, dtype=f.dtype, device=f.device)[None, :]

    def m(p, q):
        return (f * _ipow(xs, p) * _ipow(ys, q)).sum(dim=(-2, -1))

    out = {"m00": m(0, 0), "m10": m(1, 0), "m01": m(0, 1)}
    m00 = out["m00"]
    cx = out["m10"] / m00
    cy = out["m01"] / m00
    # Central moments taken around the centroid directly: the translation
    # identities (m11 - cx·m01, ...) cancel catastrophically in float32.
    dx = xs - cx[..., None, None]
    dy = ys - cy[..., None, None]
    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                out[f"mu{p}{q}"] = (f * _ipow(dx, p) * _ipow(dy, q)).sum(dim=(-2, -1))
    # Raw higher moments rebuilt additively (the cancellation-free way), so
    # the dict carries cv2.moments' full key set.
    out["m20"] = out["mu20"] + cx * out["m10"]
    out["m11"] = out["mu11"] + cx * out["m01"]
    out["m02"] = out["mu02"] + cy * out["m01"]
    out["m30"] = out["mu30"] + 3 * cx * out["m20"] - 2 * cx * cx * out["m10"]
    out["m21"] = out["mu21"] + 2 * cx * out["m11"] + cy * out["m20"] - 2 * cx * cx * out["m01"]
    out["m12"] = out["mu12"] + 2 * cy * out["m11"] + cx * out["m02"] - 2 * cy * cy * out["m10"]
    out["m03"] = out["mu03"] + 3 * cy * out["m02"] - 2 * cy * cy * out["m01"]
    # nu_pq = mu_pq / m00^(1 + (p+q)/2): m00² for order 2, m00^2.5 for 3.
    s2 = m00 * m00
    s3 = s2 * torch.sqrt(m00)
    for p in range(4):
        for q in range(4):
            if 2 <= p + q <= 3:
                out[f"nu{p}{q}"] = out[f"mu{p}{q}"] / (s2 if p + q == 2 else s3)
    return out


def hu_moments(img: torch.Tensor) -> torch.Tensor:
    """cv2.HuMoments(cv2.moments(img)): the 7 rotation invariants, [..., 7]."""
    mo = moments(img)
    n20, n02, n11 = mo["nu20"], mo["nu02"], mo["nu11"]
    n30, n12, n21, n03 = mo["nu30"], mo["nu12"], mo["nu21"], mo["nu03"]
    t0 = n30 + n12
    t1 = n21 + n03
    q0 = t0 * t0
    q1 = t1 * t1
    h = [
        n20 + n02,
        _ipow(n20 - n02, 2) + 4 * n11 * n11,
        _ipow(n30 - 3 * n12, 2) + _ipow(3 * n21 - n03, 2),
        q0 + q1,
        (n30 - 3 * n12) * t0 * (q0 - 3 * q1) + (3 * n21 - n03) * t1 * (3 * q0 - q1),
        (n20 - n02) * (q0 - q1) + 4 * n11 * t0 * t1,
        (3 * n21 - n03) * t0 * (q0 - 3 * q1) - (n30 - 3 * n12) * t1 * (3 * q0 - q1),
    ]
    return torch.stack(h, dim=-1)


@functools.lru_cache(maxsize=16)
def _zernike_basis(degree: int):
    """The (n, l) pairs with n ≤ degree, n - l even, and the coefficients
    and powers (c, p) of each radial polynomial R_nl(r) = Σ c·r^p."""
    nl = []
    coeffs = []
    for n in range(degree + 1):
        for l in range(n + 1):
            if (n - l) % 2 == 0:
                cs = []
                for m in range((n - l) // 2 + 1):
                    c = (-1) ** m * math.factorial(n - m) / (
                        math.factorial(m)
                        * math.factorial((n - 2 * m + l) // 2)
                        * math.factorial((n - 2 * m - l) // 2)
                    )
                    cs.append((c, n - 2 * m))
                nl.append((n, l))
                coeffs.append(tuple(cs))
    return tuple(nl), tuple(coeffs)


def zernike_moments(img: torch.Tensor, radius: float, degree: int = 8) -> torch.Tensor:
    """mahotas-compatible Zernike moment magnitudes of a binary/gray image.

    mahotas semantics (`zernike_moments`): pixel coordinates normalized by
    `radius` around the intensity centroid, pixels outside the unit disc
    dropped, A_nl = (n+1)/π · Σ f(x)·V*_nl(x) / Σ f(x) over the disc,
    returned as |A_nl| for n ≤ degree, (n−l) even, l ≥ 0: [..., K]."""
    f = img.to(torch.float32)
    h, w = f.shape[-2], f.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=f.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=f.device)[None, :]
    total = f.sum(dim=(-2, -1), keepdim=True)
    cx = (f * xs).sum(dim=(-2, -1), keepdim=True) / total
    cy = (f * ys).sum(dim=(-2, -1), keepdim=True) / total
    yn = (ys - cy) / f32(radius)
    xn = (xs - cx) / f32(radius)
    r = torch.sqrt(xn * xn + yn * yn)
    theta = torch.atan2(yn, xn)
    fm = torch.where(r <= 1.0, f, 0.0)
    norm = fm.sum(dim=(-2, -1))
    out = []
    for (n, l), cs in zip(*_zernike_basis(degree)):
        rad = torch.zeros_like(r)
        for c, p in cs:
            rad = rad + f32(c) * _ipow(r, p)
        re = (fm * rad * torch.cos(l * theta)).sum(dim=(-2, -1))
        im = (fm * rad * torch.sin(l * theta)).sum(dim=(-2, -1))
        out.append(torch.sqrt(re * re + im * im) * f32((n + 1) / math.pi) / norm)
    return torch.stack(out, dim=-1)
