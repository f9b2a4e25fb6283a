"""PyTorch port vs the JAX package: the models and what serves them
(opticalflowclustering_tpu_torch.models.flow_cnn / cnn / layers,
convert.from_flax_params, extras.nms, ops.resize.resize_linear_hwc,
io.images ↔ the JAX modules of the same path).

The port's models load the JAX package's flax parameters through
convert.from_flax_params, so their outputs are compared directly:
FlowCellNet probabilities within atol 1e-5 of flax `apply` with the
committed weights, SmallCNN logits within atol 1e-4 (1000 classes, larger
sums), detection boxes and NMS picks equal."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opticalflowclustering_tpu.extras import nms as jnms
from opticalflowclustering_tpu.io import images as jimages
from opticalflowclustering_tpu.models import cnn as jcnn
from opticalflowclustering_tpu.models import flow_cnn as jfc
from opticalflowclustering_tpu.ops.resize import resize_linear_hwc as j_resize_hwc
from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.extras import nms as tnms
from opticalflowclustering_tpu_torch.io import images as timages
from opticalflowclustering_tpu_torch.models import cnn as tcnn
from opticalflowclustering_tpu_torch.models import flow_cnn as tfc
from opticalflowclustering_tpu_torch.models.layers import SameConv2d, same_pads
from opticalflowclustering_tpu_torch.ops.resize import resize_linear_hwc as t_resize_hwc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO = os.path.join(REPO, "demo_out", "601_3.avi")


@pytest.fixture(scope="module")
def jparams():
    return jfc.load_params()


@pytest.fixture(scope="module")
def tmodel():
    return tfc.load_params(device="cpu")


def test_weights_copy_is_byte_equal_to_the_jax_file():
    """The port ships its own copy of flow_cnn_weights.npz; it is the JAX
    package's file, byte for byte."""
    with open(jfc._WEIGHTS, "rb") as a, open(tfc._WEIGHTS, "rb") as b:
        assert a.read() == b.read()
    assert os.path.dirname(tfc._WEIGHTS).endswith(os.path.join("opticalflowclustering_tpu_torch", "models"))


def test_from_flax_params_round_trips_the_committed_weights(jparams, tmodel):
    """convert.from_flax_params (npz path and flax pytree give the same
    state) and to_flax_params invert each other: the port's model gives
    back every array of the npz, bitwise, under the same keystr keys, and
    16 arrays in all (Conv 24/48/96, Dense 128)."""
    flat = convert.to_flax_params(tmodel)
    with np.load(tfc._WEIGHTS) as data:
        assert sorted(flat) == sorted(data.files) and len(flat) == 16
        for k in data.files:
            np.testing.assert_array_equal(flat[k], data[k], err_msg=k)
    from_tree = convert.from_flax_params("FlowCellNet", jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in tmodel.state_dict().items():
        assert torch.equal(from_tree[k], v), k
    assert tuple(tmodel.state_dict()["convs.0.weight"].shape) == (24, 3, 3, 3)
    assert tuple(tmodel.state_dict()["dense.0.weight"].shape) == (128, 96)


def test_from_flax_params_rejects_foreign_layouts(jparams):
    with pytest.raises(ValueError, match="no flax layout"):
        convert.from_flax_params("GoogLeNet", {})
    with pytest.raises(ValueError, match="has no flax parameter"):
        convert.from_flax_params("BounceClassifier", jparams)
    partial = {"params": {"Dense_0": {"kernel": np.zeros((4, 64)), "bias": np.zeros(64)}}}
    with pytest.raises(ValueError, match="expected"):
        convert.from_flax_params("BounceClassifier", partial)


@pytest.mark.parametrize("n,stride,want", [(50, 2, (0, 1)), (25, 2, (1, 1)), (13, 2, (1, 1)),
                                           (48, 2, (0, 1)), (224, 2, (0, 1)), (50, 1, (1, 1))])
def test_same_pads_is_xla_same(n, stride, want):
    """models.layers.same_pads: XLA's 'SAME' split, the low side total // 2
    (a stride-2 3×3 conv on 50 samples pads (0, 1), not (1, 1))."""
    assert same_pads(n, stride, 3) == want


@pytest.mark.parametrize("size", [50, 48, 49, 64])
def test_flowcellnet_probs_equal_flax_apply(jparams, tmodel, size):
    """jfc.FlowCellNet().apply + softmax ↔ tfc.FlowCellNet with the
    committed weights, on seeded uint8 crops of 50×50 (the served size),
    even sizes where symmetric padding would differ, and an odd size:
    probabilities within atol 1e-5. A Conv2d with padding=1 at every layer
    gives other probabilities at the even sizes, which is the trap the
    'SAME' padding avoids."""
    cells = np.random.default_rng(size).integers(0, 256, (12, size, size, 3), dtype=np.uint8)
    want = np.asarray(jax.nn.softmax(jfc.FlowCellNet().apply(jparams, jnp.asarray(cells, jnp.float32)), -1))
    got = tfc.classify_cells(tmodel, cells)
    np.testing.assert_allclose(got, want, atol=1e-5)
    if size % 2 == 0:
        sym = tfc.FlowCellNet()
        sym.load_state_dict(tmodel.state_dict())
        for conv in sym.convs:
            conv.forward = lambda x, c=conv: torch.nn.Conv2d.forward(
                c, torch.nn.functional.pad(x, (1, 1, 1, 1)))
        with torch.no_grad():
            p_sym = torch.softmax(sym(torch.from_numpy(cells)), -1).numpy()
        assert np.abs(p_sym - want).max() > 1e-4


def test_classify_cells_and_top_k_labels_equal_jax(jparams, tmodel):
    """jfc.classify_cells / top_k_labels ↔ tfc: the same ranked labels,
    probabilities within 1e-5."""
    cells = np.random.default_rng(1).integers(0, 256, (5, 50, 50, 3), dtype=np.uint8)
    jp = jfc.classify_cells(jparams, cells)
    tp = tfc.classify_cells(tmodel, cells)
    for a, b in zip(jp, tp):
        ra, rb = jfc.top_k_labels(a, 2), tfc.top_k_labels(b, 2)
        assert [r[:2] for r in ra] == [r[:2] for r in rb]
        np.testing.assert_allclose([r[2] for r in rb], [r[2] for r in ra], atol=1e-5)


@pytest.fixture(scope="module")
def flow_frames():
    """Two flow frames rendered from demo_out/601_3.avi by the port's
    pipeline on the CPU ([2, 232, 220, 3] uint8)."""
    from opticalflowclustering_tpu_torch.io.video import read_video_bgr
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig, process_frames

    frames = read_video_bgr(DEMO, 12)
    return process_frames(frames[[0, 5, 10]], PipelineConfig(chunk=2), device="cpu")["flow_bgr"]


@pytest.mark.parametrize("confidence,stride", [(0.9, 25), (0.5, 25), (0.5, 10)])
def test_detect_windows_boxes_equal_jax(jparams, tmodel, flow_frames, confidence, stride):
    """jfc.detect_windows ↔ tfc.detect_windows on flow frames rendered from
    the demo clip: the same boxes in the same order, labels equal, scores
    within 1e-5; and the window probabilities within 1e-5 of JAX's."""
    found = 0
    for frame in flow_frames:
        want = jfc.detect_windows(jparams, frame, stride=stride, confidence=confidence)
        got = tfc.detect_windows(tmodel, frame, stride=stride, confidence=confidence)
        assert [(g[0], g[2]) for g in got] == [(w[0], w[2]) for w in want]
        np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=1e-5)
        found += len(got)
        ys, xs, probs = tfc._window_probs(tmodel, frame, stride)
        wins = np.stack([frame[y : y + 50, x : x + 50] for y in ys for x in xs])
        np.testing.assert_allclose(probs.numpy(), jfc.classify_cells(jparams, wins)[:, 1], atol=1e-5)
    if confidence < 0.9:
        assert found > 0


def test_detect_windows_on_a_frame_smaller_than_a_window(jparams, tmodel):
    """A frame narrower than 50: the window spans it, as in jfc."""
    frame = np.random.default_rng(2).integers(0, 256, (60, 40, 3), dtype=np.uint8)
    _, xs, probs = tfc._window_probs(tmodel, frame, 10)
    assert xs == [0] and probs.shape == (2,)
    want = jfc.detect_windows(jparams, frame, stride=10, confidence=0.0)
    got = tfc.detect_windows(tmodel, frame, stride=10, confidence=0.0)
    assert [g[2] for g in got] == [w[2] for w in want]


def _seeded_boxes(seed, n=60):
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, 300, (n, 2))
    wh = rng.integers(20, 90, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.int32)


@pytest.mark.parametrize("seed,thresh", [(0, 0.3), (1, 0.5), (2, 0.0)])
def test_nms_host_and_device_equal_jax(seed, thresh):
    """jnms.non_max_suppression ↔ tnms.non_max_suppression: the same picks,
    byte-equal; jnms.non_max_suppression_device ↔
    tnms.non_max_suppression_device: the same keep-mask. (The two JAX
    versions may differ from each other where y2 ties: the host's numpy
    argsort is not stable.)"""
    boxes = _seeded_boxes(seed)
    want = jnms.non_max_suppression(boxes, thresh)
    got = tnms.non_max_suppression(boxes, thresh)
    assert got.tobytes() == want.tobytes() and got.dtype == want.dtype
    mask = tnms.non_max_suppression_device(torch.from_numpy(boxes), thresh)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jnms.non_max_suppression_device(boxes, thresh)))
    assert tnms.non_max_suppression(boxes[:0], thresh).shape == (0, 4)


@pytest.mark.parametrize("kw", [
    dict(size=(224, 224), mean=(104.0, 117.0, 123.0)),
    dict(size=(300, 300), scalefactor=0.007843, mean=(127.5, 127.5, 127.5), swap_rb=True),
])
def test_blob_from_image_equals_jax(kw):
    """jcnn.blob_from_image ↔ tcnn.blob_from_image on a seeded 173×131
    image: NCHW [1, 3, h, w], values within 1e-4 (the resize is a banded
    matmul on both sides)."""
    img = np.random.default_rng(4).integers(0, 256, (173, 131, 3), dtype=np.uint8)
    want = np.asarray(jcnn.blob_from_image(jnp.asarray(img), **kw))
    got = tcnn.blob_from_image(torch.from_numpy(img), **kw).numpy()
    assert got.shape == want.shape == (1, 3, kw["size"][1], kw["size"][0])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_resize_linear_hwc_equals_jax():
    """ops.resize.resize_linear_hwc ↔ the JAX function, non-integer ratios
    and an exact 2× upsample: within 1e-4."""
    img = np.random.default_rng(5).random((2, 37, 53, 3)).astype(np.float32) * 255
    for hw in ((224, 224), (74, 106), (20, 31)):
        np.testing.assert_allclose(t_resize_hwc(torch.from_numpy(img), hw).numpy(),
                                   np.asarray(j_resize_hwc(jnp.asarray(img), hw)), rtol=1e-6, atol=1e-4)


def test_smallcnn_classifier_net_equals_flax_at_224():
    """jcnn.ClassifierNet ↔ tcnn.ClassifierNet with the JAX-initialised
    SmallCNN parameters (through from_flax_params) on a 224×224 blob: 1000
    logits within atol 1e-4, and top_k equal. The port's own
    initialisation (params=None) draws flax's distribution: zero biases,
    weights within ±2σ of lecun_normal."""
    img = np.random.default_rng(6).integers(0, 256, (240, 320, 3), dtype=np.uint8)
    jnet = jcnn.ClassifierNet(seed=0)
    blob = jcnn.blob_from_image(jnp.asarray(img), mean=(104.0, 117.0, 123.0))
    jnet.set_input(blob)
    want = jnet.forward()
    tnet = tcnn.ClassifierNet(params=jax.tree_util.tree_map(np.asarray, jnet.params), device="cpu")
    tnet.set_input(tcnn.blob_from_image(torch.from_numpy(img), mean=(104.0, 117.0, 123.0)))
    got = tnet.forward()
    assert got.shape == want.shape == (1, 1000)
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert [i for i, _ in tcnn.top_k(got, 5)] == [i for i, _ in jcnn.top_k(want, 5)]
    own = tcnn.ClassifierNet(seed=0, device="cpu").model
    for name, p in own.state_dict().items():
        if name.endswith("bias"):
            assert not p.any(), name
        else:
            bound = 2 * (1 / p[0].numel()) ** 0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= bound * (1 + 1e-6) and float(p.std()) > 0.3 * bound / 2, name


def test_filter_detections_and_top_k_equal_jax():
    rng = np.random.default_rng(7)
    det = rng.random((1, 1, 30, 7)).astype(np.float32)
    det[..., 1] = rng.integers(0, 21, 30)
    assert tcnn.filter_detections(det, (300, 400), 0.4) == jcnn.filter_detections(det, (300, 400), 0.4)
    preds = rng.random(1000)
    assert tcnn.top_k(preds) == jcnn.top_k(preds)
    assert tcnn.VOC_CLASSES == jcnn.VOC_CLASSES


def test_same_conv2d_matches_flax_conv_on_odd_and_even_inputs():
    """layers.SameConv2d ↔ flax nn.Conv(strides=2) with the same kernel
    (HWIO → OIHW) on 7×10 and 8×9 inputs: within 1e-5."""
    from flax import linen as nn

    conv = nn.Conv(4, (3, 3), strides=(2, 2))
    for h, w in ((7, 10), (8, 9)):
        x = np.random.default_rng(h).random((2, h, w, 3)).astype(np.float32)
        p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
        want = np.asarray(conv.apply(p, jnp.asarray(x)))
        tc = SameConv2d(3, 4, 3, 2)
        with torch.no_grad():
            tc.weight.copy_(torch.from_numpy(np.asarray(p["params"]["kernel"]).transpose(3, 2, 0, 1)))
            tc.bias.copy_(torch.from_numpy(np.asarray(p["params"]["bias"])))
            got = tc(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)


def test_image_readers_equal_jax(tmp_path):
    """io.images.numeric_key / read_png_dir / read_cell_tree ↔ the JAX
    module on a seeded OutImgs-style tree: equal arrays, numeric order."""
    rng = np.random.default_rng(8)
    for f in (2, 10, 3):
        d = tmp_path / "tree" / str(f)
        d.mkdir(parents=True)
        for c in (1, 12, 2):
            cv2.imwrite(str(d / f"{c}.png"), rng.integers(0, 256, (6, 5, 3), dtype=np.uint8))
    for name in ("frame12.png", "frame3.png", "x.png"):
        assert timages.numeric_key(name) == jimages.numeric_key(name)
    tree = str(tmp_path / "tree")
    np.testing.assert_array_equal(timages.read_cell_tree(tree), jimages.read_cell_tree(tree))
    np.testing.assert_array_equal(timages.read_cell_tree(tree, 2), jimages.read_cell_tree(tree, 2))
    one = str(tmp_path / "tree" / "10")
    np.testing.assert_array_equal(timages.read_png_dir(one), jimages.read_png_dir(one))
    assert timages.read_png_dir(one, 2).shape == (2, 6, 5, 3)


def test_model_entry_points_default_to_the_card_and_refuse_a_missing_one(monkeypatch):
    """load_params, ClassifierNet, init_classifier, train_on_hue_windows and
    train_flow_cnn default to cuda, and raise where there is no CUDA device
    rather than running on the CPU."""
    from opticalflowclustering_tpu_torch.models import bounce_classifier as tbc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: tfc.load_params(),
        lambda: tcnn.ClassifierNet(num_classes=4),
        lambda: tbc.init_classifier(None, 9),
        lambda: tbc.train_on_hue_windows(np.zeros((4, 9), np.float32), np.zeros(4, np.float32), steps=1),
        lambda: tfc.train_flow_cnn(np.zeros((2, 50, 50, 3), np.uint8), np.zeros(2, np.int32), epochs=1, batch=2),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="is_available"):
            call()
