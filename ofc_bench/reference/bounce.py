"""Plain reference of the bounce-feature pipeline, in plain PyTorch.

A frozen, self-contained copy of the port's plain path (gray, the Gaussian
pyramid, polynomial expansion, the warp with the 'fast' reach masks, the box
solve, the HSV render, grid pooling and the k=1 dominant hue), written from
OpenCV's algorithms as the port's plain versions write them. It imports
nothing of the port, so a change to the port cannot move it.

Every float step runs in `dtype`: float32 is the reference, and bfloat16 is
the control, the step below the configuration's precision that a faster
program might take. Integer steps (gray, grid sums, the hue of a centroid)
are exact in either.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_MIN_SIZE = 32  # pyramid levels stop below 32 px on either side
_BORDER_SCALE = (0.14, 0.14, 0.4472, 0.4472, 0.4472)
_REACH = {"fast": (119, 127), "exact": None}
_DBL_EPSILON = 2.220446049250313e-16
_SMALL_GAUSSIAN = {3: [0.25, 0.5, 0.25], 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                   7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125]}
_SECTOR = ((1, 3, 0), (1, 0, 2), (3, 0, 1), (0, 2, 1), (0, 1, 3), (2, 1, 0))


def f32(c: float) -> float:
    return float(np.float32(c))


# ---- colour ---------------------------------------------------------------

def bgr2gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR2GRAY for uint8 (15-bit fixed point)."""
    x = bgr.to(torch.int32)
    y = (x[..., 0] * 3735 + x[..., 1] * 19235 + x[..., 2] * 9798 + (1 << 14)) >> 15
    return y.to(torch.uint8)


@functools.cache
def _hsv_tables() -> tuple[np.ndarray, np.ndarray]:
    i = np.arange(256, dtype=np.float64)
    with np.errstate(divide="ignore"):
        sdiv = np.rint((255 << 12) / i)
        hdiv = np.rint((180 << 12) / (6.0 * i))
    sdiv[0] = hdiv[0] = 0
    return sdiv.astype(np.int32), hdiv.astype(np.int32)


def bgr2hsv(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR2HSV for uint8 (hsv_shift 12 with OpenCV's division tables)."""
    sdiv, hdiv = (torch.from_numpy(t).to(bgr.device) for t in _hsv_tables())
    x = bgr.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    diff = v - torch.minimum(torch.minimum(b, g), r)
    s = (diff * sdiv[v.long()] + (1 << 11)) >> 12
    h = torch.where(v == r, g - b, torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff.long()] + (1 << 11)) >> 12
    h = torch.where(h < 0, h + 180, h)
    return torch.stack([h, s, v], dim=-1).to(torch.uint8)


def hsv2bgr(hsv: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """cv2 HSV2BGR for uint8 through OpenCV's scalar float path."""
    h = hsv[..., 0].to(dt) * f32(6.0 / 180.0)
    s = hsv[..., 1].to(dt) * f32(1.0 / 255.0)
    v = hsv[..., 2].to(dt) * f32(1.0 / 255.0)
    h = h - 6.0 * torch.trunc(h * f32(1.0 / 6.0))
    sector = torch.clamp(torch.floor(h).to(torch.int32), 0, 5)
    f = h - sector.to(dt)
    tab = (v, v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f)))
    channels = []
    for ch in range(3):
        val = tab[_SECTOR[0][ch]]
        for sec in range(1, 6):
            val = torch.where(sector == sec, tab[_SECTOR[sec][ch]], val)
        channels.append(val)
    return torch.clamp(torch.round(torch.stack(channels, dim=-1) * 255.0), 0, 255).to(torch.uint8)


# ---- filters and resize ---------------------------------------------------

def _gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN:
        return np.array(_SMALL_GAUSSIAN[ksize])
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma * sigma))
    return k / k.sum()


def _pad_axis(x: torch.Tensor, axis: int, r: int, mode: str) -> torch.Tensor:
    idx = np.pad(np.arange(x.shape[axis]), (r, r), mode=mode)
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def _sep_filter(x: torch.Tensor, kernel: np.ndarray, axis: int, mode: str) -> torch.Tensor:
    """Correlate one axis with a symmetric odd kernel (every kernel here is
    one), in OpenCV's order: centre + Σ w·(left + right)."""
    r = len(kernel) // 2
    axis = axis % x.ndim
    n = x.shape[axis]
    xp = _pad_axis(x, axis, r, mode)
    acc = f32(kernel[r]) * xp.narrow(axis, r, n)
    for i in range(1, r + 1):
        acc = acc + f32(kernel[r - i]) * (xp.narrow(axis, r - i, n) + xp.narrow(axis, r + i, n))
    return acc


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    k = _gaussian_kernel(ksize, sigma)
    return _sep_filter(_sep_filter(x, k, -2, "reflect"), k, -1, "reflect")


def box_sum(x: torch.Tensor, ksize: int) -> torch.Tensor:
    ones = np.ones(ksize)
    return _sep_filter(_sep_filter(x, ones, -2, "edge"), ones, -1, "edge")


def _sl(x: torch.Tensor, axis: int, lo: int, hi: int, step: int = 1) -> torch.Tensor:
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(lo, hi, step)
    return x[tuple(idx)]


def _weight_matrix(dst: int, src: int) -> np.ndarray:
    fx = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    sx = np.floor(fx).astype(np.int64)
    fx = fx - sx
    fx[sx < 0] = 0.0
    sx[sx < 0] = 0
    fx[sx >= src - 1] = 0.0
    sx[sx >= src - 1] = src - 1
    w = np.zeros((dst, src), dtype=np.float32)
    w[np.arange(dst), sx] = (1.0 - fx).astype(np.float32)
    nz = fx > 0
    w[np.arange(dst)[nz], sx[nz] + 1] = fx[nz].astype(np.float32)
    return w


def _resize_axis(x: torch.Tensor, dst: int, axis: int) -> torch.Tensor:
    src = x.shape[axis]
    if src % dst == 0:  # integer-factor downsample: one tap (odd) or two (even)
        k = src // dst
        if k % 2:
            return _sl(x, axis, (k - 1) // 2, (k - 1) // 2 + k * dst, k)
        a = _sl(x, axis, k // 2 - 1, k // 2 - 1 + k * dst, k)
        return 0.5 * a + 0.5 * _sl(x, axis, k // 2, k // 2 + k * dst, k)
    if dst == 2 * src:  # exact 2x upsample, OpenCV's border clamp at both ends
        up = torch.cat([_sl(x, axis, 0, 1), _sl(x, axis, 0, src - 1)], dim=axis)
        dn = torch.cat([_sl(x, axis, 1, src), _sl(x, axis, src - 1, src)], dim=axis)
        shape = list(x.shape)
        shape[axis] = dst
        out = torch.stack([0.25 * up + 0.75 * x, 0.75 * x + 0.25 * dn], dim=axis + 1).reshape(shape)
        first = [slice(None)] * x.ndim
        first[axis] = slice(0, 1)
        last = [slice(None)] * x.ndim
        last[axis] = slice(dst - 1, dst)
        out[tuple(first)] = _sl(x, axis, 0, 1)
        out[tuple(last)] = _sl(x, axis, src - 1, src)
        return out
    w = torch.from_numpy(_weight_matrix(dst, src)).to(x.device, x.dtype)
    return torch.matmul(w, x) if axis == x.ndim - 2 else torch.matmul(x, w.T)


def resize_linear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """cv2.resize INTER_LINEAR over the last two axes."""
    if hw[0] != x.shape[-2]:
        x = _resize_axis(x, hw[0], x.ndim - 2)
    if hw[1] != x.shape[-1]:
        x = _resize_axis(x, hw[1], x.ndim - 1)
    return x


# ---- Farneback ------------------------------------------------------------

@functools.cache
def _poly_consts(n: int, sigma: float):
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2 * sigma * sigma))
    g /= g.sum()
    g = g.astype(np.float32).astype(np.float64)
    xg = (x * g).astype(np.float32).astype(np.float64)
    xxg = (x * x * g).astype(np.float32).astype(np.float64)
    gram = np.zeros((6, 6))
    for yy in x:
        for xx in x:
            w = g[int(yy) + n] * g[int(xx) + n]
            gram[0, 0] += w
            gram[1, 1] += w * xx * xx
            gram[3, 3] += w * xx**4
            gram[5, 5] += w * xx * xx * yy * yy
    gram[2, 2] = gram[0, 3] = gram[0, 4] = gram[3, 0] = gram[4, 0] = gram[1, 1]
    gram[4, 4] = gram[3, 3]
    gram[3, 4] = gram[4, 3] = gram[5, 5]
    inv = np.linalg.inv(gram)
    return g, xg, xxg, inv[1, 1], inv[0, 3], inv[3, 3], inv[5, 5]


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """[B, H, W] → channel-first coefficients [B, 5, H, W] (y, x, y², x², xy)."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_consts(n, sigma)
    h, w = img.shape[-2:]
    xp = _pad_axis(img, 1, n, "edge")
    t0 = f32(g[n]) * xp.narrow(1, n, h)
    t1 = torch.zeros_like(t0)
    t2 = torch.zeros_like(t0)
    for k in range(1, n + 1):
        up, down = xp.narrow(1, n - k, h), xp.narrow(1, n + k, h)
        t0 = t0 + f32(g[n + k]) * (up + down)
        t1 = t1 + f32(xg[n + k]) * (down - up)
        t2 = t2 + f32(xxg[n + k]) * (up + down)
    t0p, t1p, t2p = (_pad_axis(t, 2, n, "edge") for t in (t0, t1, t2))
    b1 = f32(g[n]) * t0p.narrow(2, n, w)
    b3 = f32(g[n]) * t1p.narrow(2, n, w)
    b5 = f32(g[n]) * t2p.narrow(2, n, w)
    b2 = torch.zeros_like(b1)
    b4 = torch.zeros_like(b1)
    b6 = torch.zeros_like(b1)
    for k in range(1, n + 1):
        l0, r0 = t0p.narrow(2, n - k, w), t0p.narrow(2, n + k, w)
        l1, r1 = t1p.narrow(2, n - k, w), t1p.narrow(2, n + k, w)
        l2, r2 = t2p.narrow(2, n - k, w), t2p.narrow(2, n + k, w)
        b1 = b1 + f32(g[n + k]) * (l0 + r0)
        b4 = b4 + f32(xxg[n + k]) * (l0 + r0)
        b2 = b2 + f32(xg[n + k]) * (r0 - l0)
        b6 = b6 + f32(xg[n + k]) * (r1 - l1)
        b3 = b3 + f32(g[n + k]) * (l1 + r1)
        b5 = b5 + f32(g[n + k]) * (l2 + r2)
    return torch.stack([b3 * f32(ig11), b2 * f32(ig11), b5 * f32(ig33) + b1 * f32(ig03),
                        b4 * f32(ig33) + b1 * f32(ig03), b6 * f32(ig55)], dim=1)


def _taper(h: int, w: int) -> np.ndarray:
    def ramp(n):
        r = np.ones(n, dtype=np.float32)
        for i in range(min(5, n)):
            r[i] *= np.float32(_BORDER_SCALE[i])
            r[n - 1 - i] *= np.float32(_BORDER_SCALE[i])
        return r

    return ramp(h)[:, None] * ramp(w)[None, :]


def update_matrices(r0, r1, dx, dy, reach) -> torch.Tensor:
    """M [B, 5, H, W] from r0, r1 [B, 5, H, W] and the flow planes [B, H, W]:
    bilinear warp of r1, OpenCV's out-of-image fallback (with the reach
    masks |y1−y| ≤ 119, |x1−x| ≤ 127 of 'fast'), the normal equations and
    the 5-px border taper."""
    b, c, h, w = r1.shape
    dev = dx.device
    ys = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    gx = xs.to(dx.dtype) + dx
    gy = ys.to(dx.dtype) + dy
    x1 = torch.floor(gx)
    y1 = torch.floor(gy)
    fx = gx - x1
    fy = gy - y1
    x1i = x1.to(torch.int32)
    y1i = y1.to(torch.int32)
    base = (torch.clamp(y1i, 0, h - 2).long() * w + torch.clamp(x1i, 0, w - 2).long())
    base = base.reshape(b, 1, h * w).expand(b, c, h * w)
    flat = r1.reshape(b, c, h * w)

    def corner(off):
        return torch.gather(flat, -1, base + off).reshape(b, c, h, w)

    fxe, fye = fx.unsqueeze(1), fy.unsqueeze(1)
    r1w = (corner(0) * (1 - fxe) * (1 - fye) + corner(1) * fxe * (1 - fye)
           + corner(w) * (1 - fxe) * fye + corner(w + 1) * fxe * fye)
    inb = (x1i >= 0) & (x1i <= w - 2) & (y1i >= 0) & (y1i <= h - 2)
    if reach is not None:
        inb = inb & ((y1i - ys).abs() <= reach[0]) & ((x1i - xs).abs() <= reach[1])
    taper = torch.from_numpy(_taper(h, w)).to(dev, dx.dtype)
    a, q = r0.unbind(1), r1w.unbind(1)
    r4 = torch.where(inb, (a[2] + q[2]) * 0.5, a[2])
    r5 = torch.where(inb, (a[3] + q[3]) * 0.5, a[3])
    r6 = torch.where(inb, (a[4] + q[4]) * 0.25, a[4] * 0.5)
    r2 = (a[0] - torch.where(inb, q[0], 0.0)) * 0.5
    r3 = (a[1] - torch.where(inb, q[1], 0.0)) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    r2, r3, r4, r5, r6 = (t * taper for t in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        r4 * r2 + r6 * r3, r6 * r2 + r5 * r3], dim=1)


def solve_flow(m: torch.Tensor, winsize: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The winsize² box average of M and the 2×2 solve with det + 1e-3."""
    s = box_sum(m, winsize) * f32(1.0 / (winsize * winsize))
    g11, g12, g22, h1, h2 = s.unbind(1)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + f32(1e-3))
    return (g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet


def pyramid_plan(h: int, w: int, pyr_scale: float, levels: int) -> list[tuple[int, int, int, float]]:
    """[(k, h_k, w_k, sigma_k)] from coarsest to finest, with OpenCV's stop
    below 32 px."""
    n, scale = 0, 1.0
    for k in range(levels):
        scale *= pyr_scale
        if w * scale < _MIN_SIZE or h * scale < _MIN_SIZE:
            break
        n = k + 1
    return [(k, int(np.rint(h * pyr_scale**k)), int(np.rint(w * pyr_scale**k)),
             (1.0 / pyr_scale**k - 1.0) * 0.5) for k in range(n, -1, -1)]


def farneback_flow(prev: torch.Tensor, nxt: torch.Tensor, fb: dict, dt: torch.dtype) -> torch.Tensor:
    """Dense flow of gray pairs [B, H, W] uint8 → [B, H, W, 2] in `dt`."""
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
            fx, fy = solve_flow(update_matrices(r0, r1, fx, fy, reach), fb["winsize"])
    return torch.stack([fx, fy], dim=-1)


# ---- render and features --------------------------------------------------

def _fast_atan2_deg(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    d = 180.0 / 3.141592653589793
    p1, p3, p5, p7 = (f32(c * d) for c in (0.9997878412794807, -0.3258083974640975,
                                           0.1555786518463281, -0.04432655554792128))
    ax, ay = x.abs(), y.abs()
    c = torch.minimum(ax, ay) / (torch.maximum(ax, ay) + f32(_DBL_EPSILON))
    c2 = c * c
    a = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * c
    a = torch.where(ax >= ay, a, 90.0 - a)
    a = torch.where(x < 0, 180.0 - a, a)
    return torch.where(y < 0, 360.0 - a, a)


def render_flow(flow: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """flow [B, H, W, 2] → (|flow| [B, H, W], its HSV render as BGR uint8:
    hue = angle/2 truncated, full saturation, value = per-frame min-max of
    the magnitude)."""
    fx, fy = flow[..., 0], flow[..., 1]
    dt = flow.dtype
    mag = torch.sqrt(fx * fx + fy * fy)
    ang = _fast_atan2_deg(fy, fx) * f32(3.141592653589793 / 180.0)
    hue = (ang * f32(180.0 / 3.141592653589793 / 2.0)).to(torch.uint8)
    smin = torch.amin(mag, dim=(-2, -1), keepdim=True)
    smax = torch.amax(mag, dim=(-2, -1), keepdim=True)
    delta = smax - smin
    scale = torch.where(delta > f32(_DBL_EPSILON), torch.full_like(delta, 255.0) / delta, 0.0)
    val = (mag * scale + (0.0 - smin * scale)).to(torch.uint8)
    hsv = torch.stack([hue, torch.full_like(hue, 255), val], dim=-1)
    return mag, hsv2bgr(hsv, dt)


def _frame_lines(frames: torch.Tensor, rows: int, cols: int, own: bool) -> torch.Tensor:
    """The reference's white 1-px grid lines drawn onto [B, H, W, 3] frames."""
    h, w = frames.shape[-3], frames.shape[-2]
    ys, xs = h // rows, w // cols
    y = torch.arange(h, device=frames.device)[:, None]
    x = torch.arange(w, device=frames.device)[None, :]
    inside = (y < rows * ys) & (x < cols * xs)
    line = ((y % ys == 0) | (x % xs == 0)) if own else (((y % ys == 0) & (y >= ys)) | ((x % xs == 0) & (x >= xs)))
    return torch.where((inside & line)[..., None], torch.tensor(255, dtype=frames.dtype, device=frames.device),
                       frames)


def _cell_sums(frames: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    b, h, w, c = frames.shape
    ys, xs = h // rows, w // cols
    x = frames[:, : rows * ys, : cols * xs].to(torch.int64)
    return x.reshape(b, rows, ys, cols, xs, c).sum(dim=(2, 4)).reshape(b, rows * cols, c)


def grid_tables(flow_bgr: torch.Tensor, rows: int, cols: int, rb_swap: bool):
    """(centroids [B, cells, 4] int32, hue [B, cells] uint8, rgb hue [B, cells]
    float32) of rendered frames: the k=1 cluster centre of each cell's RGBA
    pixels (dark channels zeroed, alpha from gray, own white lines) and the
    hue of each cell's mean BGR (the lines its neighbours drew)."""
    h, w = flow_bgr.shape[-3], flow_bgr.shape[-2]
    area = (h // rows) * (w // cols)
    x = _frame_lines(flow_bgr, rows, cols, own=True)
    if rb_swap:
        x = x.flip(-1)
    x = torch.where(x < 30, torch.zeros_like(x), x)
    alpha = torch.where(bgr2gray(x) > 0, 255, 0).to(torch.uint8)
    s = _cell_sums(torch.cat([x, alpha[..., None]], dim=-1), rows, cols)
    m, rem = s // area, s % area
    centroid = m + ((2 * rem > area) | ((2 * rem == area) & (m % 2 == 1))).to(m.dtype)
    hue = bgr2hsv(centroid[..., :3].to(torch.uint8))[..., 0]
    mean_bgr = (_cell_sums(_frame_lines(flow_bgr, rows, cols, own=False), rows, cols) // area).to(torch.uint8)
    return centroid.to(torch.int32), hue, bgr2hsv(mean_bgr)[..., 0].to(torch.float32)


@torch.inference_mode()
def clip_tables(frames: np.ndarray, cfg: dict, device: str | torch.device,
                dtype: torch.dtype = torch.float32, emit_flow_bgr: bool = False) -> dict[str, np.ndarray]:
    """Tables of every pair of a clip [N, H, W, 3] uint8 BGR, computed on
    `device` in blocks of `cfg['chunk']` pairs: hue_table, rgb_hue_table,
    centroids, mean_magnitude (and flow_bgr when asked)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fb, grid, chunk = cfg["farneback"], cfg["grid"], cfg["chunk"]
    n_pairs = frames.shape[0] - 1
    parts: dict[str, list[np.ndarray]] = {}
    for start in range(0, n_pairs, chunk):
        # Every block holds `chunk` pairs, the last one padded with its final
        # frame, so each reduction runs at one shape.
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
