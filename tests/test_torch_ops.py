"""PyTorch port vs the JAX package: colorspace, filters, resize and polar ops
(opticalflowclustering_tpu_torch.ops ↔ opticalflowclustering_tpu.ops).

Inputs are made with numpy from a seed and fed to both. The JAX functions
run un-jitted, op by op, so no multiply-add is contracted on either side and
the integer paths, and the float paths with one fixed op order, compare
bitwise."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.ops import colorspace as jcs
from opticalflowclustering_tpu.ops import filters as jfi
from opticalflowclustering_tpu.ops import polar as jpo
from opticalflowclustering_tpu.ops import resize as jrs
from opticalflowclustering_tpu_torch.ops import colorspace as tcs
from opticalflowclustering_tpu_torch.ops import filters as tfi
from opticalflowclustering_tpu_torch.ops import polar as tpo
from opticalflowclustering_tpu_torch.ops import resize as trs

torch.set_num_threads(1)

_EDGES = (0, 1, 29, 30, 127, 128, 179, 180, 254, 255)


def _pixels(seed):
    """2^18 seeded uint8 triples plus every triple of edge values."""
    rng = np.random.default_rng(seed)
    sample = rng.integers(0, 256, (1 << 18, 3), dtype=np.uint8)
    edges = np.array(list(itertools.product(_EDGES, repeat=3)), np.uint8)
    return np.concatenate([sample, edges]).reshape(-1, 8, 3)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize(
    "name", ["bgr2gray", "bgr2hsv", "hsv2bgr", "bgr2rgb"]
)
def test_colorspace_bitwise(name):
    """jcs.<name> ↔ tcs.<name>: the fixed-point and float32 scalar paths
    give identical bytes."""
    px = _pixels(1)
    want = np.asarray(getattr(jcs, name)(jnp.asarray(px)))
    got = getattr(tcs, name)(_t(px)).numpy()
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(64, 128), (72, 136), (75, 131)])
@pytest.mark.parametrize("border", ["reflect101", "replicate"])
def test_gaussian_blur_and_box_sum(hw, border):
    """jfi.gaussian_blur / box_sum ↔ tfi: rtol 1e-6, atol 1e-5 (the same
    symmetric-pair sums; only float32 rounding could differ)."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 255, (2,) + hw).astype(np.float32)
    for ksize, sigma in [(3, 0.0), (7, 1.5), (9, 0.0), (5, 2.5)]:
        want = np.asarray(jfi.gaussian_blur(x, ksize, sigma, border=border))
        got = tfi.gaussian_blur(_t(x), ksize, sigma, border=border).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    for ksize in (3, 15, 17):
        want = np.asarray(jfi.box_sum(x, ksize, border=border))
        got = tfi.box_sum(_t(x), ksize, border=border).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize(
    "src,dst,bitwise",
    [
        ((64, 128), (32, 64), True),  # integer-ratio down, even factor
        ((72, 136), (24, 136), True),  # integer-ratio down, odd factor
        ((64, 128), (128, 256), True),  # exact 2x up
        ((72, 136), (36, 272), True),  # down on H, up on W
        ((75, 131), (38, 66), False),  # banded matmul on both axes
        ((75, 131), (150, 100), False),  # 2x up on H, banded on W
    ],
)
def test_resize_linear(src, dst, bitwise):
    """jrs.resize_linear ↔ trs.resize_linear: the integer-ratio and 2x paths
    bitwise; the banded matmul within rtol 1e-6, atol 1e-5."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-50, 255, (3,) + src).astype(np.float32)
    want = np.asarray(jrs.resize_linear(x, dst))
    got = trs.resize_linear(_t(x), dst).numpy()
    assert got.shape == want.shape == (3,) + dst
    if bitwise:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


def test_linear_weight_matrix_copy():
    for dst, src in [(38, 75), (66, 131), (100, 75), (7, 3)]:
        np.testing.assert_array_equal(
            trs._linear_weight_matrix(dst, src), jrs._linear_weight_matrix(dst, src)
        )


def _flows(seed):
    rng = np.random.default_rng(seed)
    f = rng.normal(0, 5, (3, 40, 64, 2)).astype(np.float32)
    f[0, :4] = 0.0  # zero vectors: the epsilon guard and the 0° branch
    f[1, :, :3, 0] = 0.0  # the axes
    f[2, :3, :, 1] = -f[2, :3, :, 0]  # |x| == |y| diagonals
    return f


def test_fast_atan2_and_magnitude_within_one_ulp():
    """jpo.fast_atan2_deg / magnitude / cart_to_polar ↔ tpo: ≤ 1 ulp."""
    f = _flows(4)
    x, y = f[..., 0], f[..., 1]
    np.testing.assert_array_max_ulp(
        tpo.fast_atan2_deg(_t(y), _t(x)).numpy(),
        np.asarray(jpo.fast_atan2_deg(y, x)),
        maxulp=1,
    )
    np.testing.assert_array_max_ulp(
        tpo.magnitude(_t(x), _t(y)).numpy(), np.asarray(jpo.magnitude(x, y)), maxulp=1
    )
    for deg in (False, True):
        tm, ta = tpo.cart_to_polar(_t(x), _t(y), angle_in_degrees=deg)
        jm, ja = jpo.cart_to_polar(x, y, angle_in_degrees=deg)
        np.testing.assert_array_max_ulp(ta.numpy(), np.asarray(ja), maxulp=1)
        np.testing.assert_array_max_ulp(tm.numpy(), np.asarray(jm), maxulp=1)


@pytest.mark.parametrize("axis", [None, (-2, -1)])
def test_normalize_minmax_within_one_ulp(axis):
    """jpo.normalize_minmax ↔ tpo.normalize_minmax: ≤ 1 ulp, per frame and
    over the whole batch; a constant frame takes the zero-scale branch."""
    mag = np.linalg.norm(_flows(5), axis=-1).astype(np.float32)
    mag[1] = 3.0
    got = tpo.normalize_minmax(_t(mag), 0.0, 255.0, axis=axis).numpy()
    want = np.asarray(jpo.normalize_minmax(mag, 0.0, 255.0, axis=axis))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
