"""PyTorch port vs the JAX package: the uint8 colour conversions over every
input (opticalflowclustering_tpu_torch.ops.colorspace ↔
opticalflowclustering_tpu.ops.colorspace).

bgr2gray, rgb2gray, bgr2hsv and hsv2bgr are held bitwise against the JAX
functions run eagerly (op by op, not under jit: jit and eager differ on 689
hsv2bgr inputs, all with S ≠ 255) over all 256³ three-channel codes, in
chunks of 2^21 pixels. hsv2bgr takes H mod 180, OpenCV's hue range."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.ops import colorspace as jcs
from opticalflowclustering_tpu_torch.ops import colorspace as tcs

torch.set_num_threads(1)

CHUNK = 1 << 21


def _all_codes(hue_mod_180=False):
    """Every (c0, c1, c2) uint8 triple, in chunks of CHUNK pixels."""
    for start in range(0, 1 << 24, CHUNK):
        code = np.arange(start, start + CHUNK, dtype=np.uint32)
        x = np.stack([code & 255, (code >> 8) & 255, code >> 16], -1).astype(np.uint8)
        if hue_mod_180:
            x[:, 0] %= 180
        yield x


@pytest.mark.parametrize("name", ["bgr2gray", "rgb2gray", "bgr2hsv", "hsv2bgr"])
def test_colour_conversion_equals_eager_jax_on_every_input(name):
    """tcs.<name> ↔ jcs.<name> (eager) on all 2^24 inputs: array_equal."""
    differ = 0
    for x in _all_codes(hue_mod_180=name == "hsv2bgr"):
        got = getattr(tcs, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jcs, name)(jnp.asarray(x)))
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
        differ += int((got != want).sum())
    assert differ == 0


def test_rgb2gray_is_bgr2gray_of_the_flipped_channels():
    """tcs.rgb2gray ↔ jcs.rgb2gray on seeded batched frames with leading
    dims: equal, and equal to bgr2gray of the channel-flipped frames."""
    x = np.random.default_rng(0).integers(0, 256, (2, 3, 17, 29, 3), dtype=np.uint8)
    got = tcs.rgb2gray(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcs.rgb2gray(jnp.asarray(x))))
    np.testing.assert_array_equal(got, tcs.bgr2gray(torch.from_numpy(x[..., ::-1].copy())).numpy())
    assert got.shape == (2, 3, 17, 29)
