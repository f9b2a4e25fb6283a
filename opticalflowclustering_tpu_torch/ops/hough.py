"""Hough circle detection (port of `opticalflowclustering_tpu/ops/hough.py`;
the reference is `detect-circles/detect_circles.py:13`, cv2.HoughCircles
HOUGH_GRADIENT dp=1.2 minDist=75).

The reference's gradient-vote detector, in four stages on the tensor's
device (the module docstring of the JAX package gives the derivation):

* **Voting**, cv2's fixed-point ray walk: each Canny edge pixel with a
  nonzero Sobel gradient votes along ±gradient at every integer radius, at
  ``(round(x·idp·1024) + r·round(idp·cosθ·1024)) >> 10``. The votes of
  all edge pixels for a block of radii are one integer `bincount`, exact
  on the card (integer atomics).
* **Centres**: cells > param2 that are strictly greater than their
  left/top and >= their right/bottom neighbours; at most `n_candidates`,
  the largest first, ties to the lower index (a stable sort).
* **Radius support**, batched over candidates: each candidate's edge
  points binned by distance (bins of dp/10). The gated mode keeps only the
  points whose gradient line passes within `direction_tol`·dp of the
  centre and takes the dp-wide window with the most points per radius;
  `coherence_gate=False` reproduces cv2's raw estimator, a walk over the
  bins from the top that is sequential in its windows (one batched step
  per window for all candidates).
* **Selection** on the host (the passed candidates are few): support desc,
  radius desc, x asc, y asc, then a greedy Euclidean minDist dedup.

The JAX function is one jitted program, and XLA's CPU backend contracts a
multiply feeding an add into one fused multiply-add. Where that moves a
vote or a bin (the hypot inside the voting direction, the distance, the
gate's cross product, the window radius), the port computes the same fused
result: the product and the sum in float64, rounded once to float32. The
hypot is JAX's own formula, max·sqrt(1 + (min/max)²), not a library hypot.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.ops.edges import canny, sobel
from opticalflowclustering_tpu_torch.runtime import f32, resolve_device

# Elements of one batched intermediate (votes of a block of radii, or
# distances of a block of candidates): bounds the device memory per step.
_BLOCK = 1 << 24
# Raw-mode windows between two checks that every candidate has finished.
_RAW_CHECK = 16


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once to float32: XLA's contracted multiply-add."""
    a = a.to(torch.float64)
    b = b.to(torch.float64) if isinstance(b, torch.Tensor) else b
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else c
    return (a * b + c).to(torch.float32)


def _hypot(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """jnp.hypot of finite float32: max·sqrt(1 + (min/max)²), 0 where both
    are 0."""
    x1, x2 = x1.abs(), x2.abs()
    hi, lo = torch.maximum(x1, x2), torch.minimum(x1, x2)
    q = lo / torch.where(hi == 0, 1.0, hi)
    return torch.where(hi == 0, hi, hi * torch.sqrt(_fma(q, q, 1.0)))


def _votes(sx, sy, x0, y0, radii: torch.Tensor, ah: int, aw: int) -> torch.Tensor:
    """Accumulator [ah, aw] int64 of every edge pixel's votes at `radii`."""
    acc = torch.zeros(ah * aw, dtype=torch.int64, device=sx.device)
    step = max(1, _BLOCK // max(2 * sx.numel(), 1))
    for i in range(0, radii.numel(), step):
        r = radii[i : i + step, None]
        for sign in (1, -1):
            x2 = (x0 + sign * r * sx) >> 10
            y2 = (y0 + sign * r * sy) >> 10
            ok = (x2 >= 0) & (x2 < aw) & (y2 >= 0) & (y2 < ah)
            acc += torch.bincount((y2 * aw + x2)[ok], minlength=ah * aw)
    return acc.view(ah, aw)


def _centres(acc: torch.Tensor, acc_threshold: float, n_candidates: int):
    """(ay, ax) int64 of the accumulator's local maxima above the threshold:
    at most n_candidates, the largest first, ties to the lower flat index."""
    pad = torch.nn.functional.pad(acc, (1, 1, 1, 1))
    c = pad[1:-1, 1:-1]
    local_max = ((c > int(acc_threshold)) & (c > 0) & (c > pad[1:-1, :-2]) & (c >= pad[1:-1, 2:])
                 & (c > pad[:-2, 1:-1]) & (c >= pad[2:, 1:-1]))
    idx = torch.nonzero(local_max.ravel()).ravel()
    if idx.numel() > n_candidates:
        order = torch.sort(c.ravel()[idx], descending=True, stable=True).indices[:n_candidates]
        idx = idx[order]
    aw = acc.shape[1]
    return idx // aw, idx % aw


def _histograms(cx, cy, px, py, ux, uy, min_radius, max_radius, nbins, bin_size, tol):
    """[K, nbins] int64 distance histograms of the edge points (px, py) around
    the centres (cx, cy); with `tol`, only points whose gradient line passes
    within tol of the centre."""
    ddx = cx[:, None] - px[None, :]
    ddy = cy[:, None] - py[None, :]
    d = torch.sqrt(_fma(ddx, ddx, ddy * ddy))
    sel = (d >= min_radius) & (d <= max_radius)
    if tol is not None:
        sel &= _fma(ddx, uy[None, :], -(ddy * ux[None, :])).abs() <= tol
    bins = torch.clamp(torch.round((d - f32(min_radius)) / f32(bin_size)).to(torch.int64), 0, nbins - 1)
    flat = bins + torch.arange(cx.numel(), device=cx.device)[:, None] * nbins
    return torch.bincount(flat[sel], minlength=cx.numel() * nbins).view(cx.numel(), nbins)


def _gated_support(hist, dp: float, min_radius: int):
    """The dp-wide (10-bin) window with the most points per radius, the
    radius floored at 1 px: (radius, support) per candidate."""
    nbins = hist.shape[1]
    cs = torch.nn.functional.pad(torch.cumsum(hist, dim=1), (10, 0))
    win = cs[:, 10:] - cs[:, :-10]  # count in bins [j-9..j], index j
    j = torch.arange(nbins, dtype=torch.float32, device=hist.device)
    r_cur = _fma((j * 2.0 - 9.0) / 20.0, f32(dp), f32(min_radius))
    score = torch.where((win > 0) & (r_cur > 0), win.to(torch.float32) / torch.clamp_min(r_cur, 1.0), -1.0)
    b = torch.argmax(score, dim=1)
    return r_cur[b], win.gather(1, b[:, None])[:, 0]


def _raw_support(hist, bin_size: float, min_radius: int):
    """cv2's estimator: walking the bins down from the top, each nonempty
    bin j > 0 anchors a window of bins [j - min(9, j), j] and the bin below
    a window is skipped; a window of count `cur` at radius
    ((j + max(j - 10, -1)) // 2)·bin_size replaces the best when
    cur·r_best >= best·r (or, while r_best is 0, when cur >= best). One step
    per window, all candidates at once: (radius, support) per candidate."""
    k, nbins = hist.shape
    dev = hist.device
    cs = torch.nn.functional.pad(torch.cumsum(hist, dim=1), (1, 0))
    j = torch.arange(nbins, device=dev)
    # Largest bin <= j that can anchor a window (nonempty, > 0), or -1.
    anchor = torch.cummax(torch.where((hist > 0) & (j > 0), j, -1), dim=1).values
    rows = torch.arange(k, device=dev)
    cursor = torch.full((k,), nbins - 1, dtype=torch.int64, device=dev)
    r_bst = torch.zeros(k, dtype=torch.float32, device=dev)
    m_cnt = torch.zeros(k, dtype=torch.int64, device=dev)
    step = 0
    while True:
        live = cursor >= 1
        up = torch.where(live, anchor[rows, cursor.clamp_min(0)], -1)
        live = up >= 1
        end = up - torch.clamp(up, max=9)
        cur = cs[rows, (up + 1).clamp_min(0)] - cs[rows, end.clamp_min(0)]
        r_cur = _fma(torch.div(up + torch.clamp_min(up - 10, -1), 2, rounding_mode="floor").to(torch.float32),
                     f32(bin_size), f32(min_radius))
        curf, mf = cur.to(torch.float32), m_cnt.to(torch.float32)
        take = live & ((curf * r_bst >= mf * r_cur) | ((r_bst < f32(1e-7)) & (cur >= m_cnt)))
        r_bst = torch.where(take, r_cur, r_bst)
        m_cnt = torch.where(take, cur, m_cnt)
        cursor = torch.where(live, end - 2, -1)
        step += 1
        if step % _RAW_CHECK == 0 and not bool((cursor >= 1).any()):
            return r_bst, m_cnt


def hough_circles_device(
    gray: torch.Tensor,
    *,
    dp: float = 1.2,
    min_dist: float = 75.0,
    canny_high: float = 100.0,
    acc_threshold: float = 100.0,
    min_radius: int = 0,
    max_radius: int = 0,
    max_circles: int = 16,
    n_candidates: int = 4096,
    direction_tol: float = 2.0,
    coherence_gate: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """[H, W] uint8 on any device → (circles [max_circles, 3] (x, y, r)
    float32, valid [max_circles] bool) on that device, as the JAX function
    returns them: circles in descending support order, `valid` monotone,
    the unused rows (-1e9, -1e9, 0). `max_radius<=0` → max(H, W),
    `min_radius<0` → 0 (cv2 defaults); `direction_tol` is the gate in units
    of dp."""
    dev = gray.device
    h, w = gray.shape
    if max_radius <= 0:
        max_radius = max(h, w)
    min_radius = max(0, min_radius)
    idp = 1.0 / dp
    ah, aw = int(np.ceil(h * idp)), int(np.ceil(w * idp))

    # cv2.HoughCircles' Sobel has BORDER_REPLICATE, as the Canny it feeds.
    edges = canny(gray, canny_high / 2.0, canny_high) > 0
    gx = sobel(gray, 1, 0, 3, border="replicate")
    gy = sobel(gray, 0, 1, 3, border="replicate")
    votable = edges & ((gx != 0) | (gy != 0))
    py, px = (v.to(torch.float32) for v in torch.nonzero(votable, as_tuple=True))
    gx, gy = gx[votable], gy[votable]
    safe = _hypot(gx, gy)  # > 0: a votable pixel has a nonzero gradient
    # cv2's fixed-point voting (SHIFT=10), in its float32 operation order,
    # ((v·idp)·1024)/|g|: half-even rounding at .5 depends on that order.
    idp_f, one_f = f32(idp), 1024.0
    sx = torch.round(gx * idp_f * one_f / safe).to(torch.int64)
    sy = torch.round(gy * idp_f * one_f / safe).to(torch.int64)
    x0 = torch.round(px * idp_f * one_f).to(torch.int64)
    y0 = torch.round(py * idp_f * one_f).to(torch.int64)
    radii = torch.arange(min_radius, max_radius + 1, dtype=torch.int64, device=dev)
    acc = _votes(sx, sy, x0, y0, radii, ah, aw)

    ay, ax = _centres(acc, acc_threshold, n_candidates)
    f_dp = f32(dp)
    cxs = (ax.to(torch.float32) + 0.5) * f_dp
    cys = (ay.to(torch.float32) + 0.5) * f_dp
    bin_size = dp / 10.0
    nbins = int(round((max_radius - min_radius) / bin_size)) + 1
    tol = f32(direction_tol * dp) if coherence_gate else None
    ux, uy = gx / safe, gy / safe
    rs, supports = [], []
    step = max(1, _BLOCK // max(px.numel(), nbins, 1))
    for i in range(0, cxs.numel(), step):
        hist = _histograms(cxs[i : i + step], cys[i : i + step], px, py, ux, uy,
                           min_radius, max_radius, nbins, bin_size, tol)
        r, s = _gated_support(hist, dp, min_radius) if coherence_gate else _raw_support(hist, bin_size, min_radius)
        rs.append(r)
        supports.append(s)
    circles = np.zeros((max_circles, 3), np.float32)
    circles[:, :2] = -1e9
    n_acc = 0
    if rs:
        cand = torch.stack([cxs, cys, torch.cat(rs)], dim=-1).cpu().numpy()
        supports = torch.cat(supports).cpu().numpy()
        passed = supports > int(acc_threshold)
        cand, supports = cand[passed], supports[passed]
        # cv2's order: support desc, radius desc, x asc, y asc.
        order = np.lexsort((cand[:, 1], cand[:, 0], -cand[:, 2], -supports))
        min_dist2 = np.float32(min_dist * min_dist)
        for x, y, r in cand[order]:
            if n_acc == max_circles:
                break
            dx, dy = circles[:n_acc, 0] - x, circles[:n_acc, 1] - y
            d2 = (dx.astype(np.float64) * dx + (dy * dy)).astype(np.float32)
            if not (d2 < min_dist2).any():
                circles[n_acc] = (x, y, r)
                n_acc += 1
    return torch.from_numpy(circles).to(dev), torch.arange(max_circles, device=dev) < n_acc


def hough_circles(
    gray,
    dp: float = 1.2,
    min_dist: float = 75.0,
    canny_high: float = 100.0,
    acc_threshold: float = 100.0,
    min_radius: int = 0,
    max_radius: int = 0,
    max_circles: int = 16,
    coherence_gate: bool = True,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """[H, W] uint8 (numpy or tensor) → [K, 3] (x, y, r) float32 circles
    (K ≤ max_circles) in support order, computed on `device` (default: the
    tensor's device, or cuda for a numpy image). Defaults mirror
    `cv2.HoughCircles(gray, HOUGH_GRADIENT, 1.2, 75)` (`detect_circles.py:13`):
    param1=100 → canny_high, param2=100 → acc_threshold, unbounded radius.
    `coherence_gate=False` reproduces cv2's raw distance-count semantics."""
    if device is None:
        device = gray.device if isinstance(gray, torch.Tensor) else "cuda"
    gray = torch.as_tensor(gray).to(resolve_device(device))
    circles, valid = hough_circles_device(
        gray, dp=dp, min_dist=min_dist, canny_high=canny_high, acc_threshold=acc_threshold,
        min_radius=min_radius, max_radius=max_radius, max_circles=max_circles, coherence_gate=coherence_gate)
    return circles[valid].cpu().numpy()
