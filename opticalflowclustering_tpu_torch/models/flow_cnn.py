"""FlowCellNet: the committed CNN for the cv2.dnn classification and
detection slots (port of `opticalflowclustering_tpu/models/flow_cnn.py`).

A 3-block ConvNet over 50×50 BGR flow-rendered cells, trained by the JAX
package on the reference's labeled footage ("bounce-clip flow" against
"no-bounce flow"). The port keeps its own byte-equal copy of the committed
weights (`flow_cnn_weights.npz`, keyed like `jax.tree_util.keystr` of the
flax params) and loads it through `convert.from_flax_params`.

Inputs stay NHWC at the API ([B, 50, 50, 3]); every convolution pads flax's
'SAME' way (models/layers.py). Detection scores every 50×50 window of a
frame at `stride` in one batched forward on the model's device, then runs
the host NMS.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.extras.nms import non_max_suppression
from opticalflowclustering_tpu_torch.models.layers import SameConv2d, flax_init_
from opticalflowclustering_tpu_torch.runtime import f32, resolve_device

CLASS_NAMES = ("no-bounce flow", "bounce-clip flow")
_WEIGHTS = os.path.join(os.path.dirname(__file__), "flow_cnn_weights.npz")
CELL = 50


class FlowCellNet(nn.Module):
    """[B, 50, 50, 3] BGR (uint8 or float, NHWC) → class logits [B, 2]:
    x·(1/255) − 0.5, three blocks of a stride-2 and a stride-1 3×3 conv
    (24, 48, 96 features) with ReLU, the mean over H and W, Dense 128 with
    ReLU, Dense num_classes."""

    def __init__(self, num_classes: int = 2):
        super().__init__()
        convs, c_in = [], 3
        for feat in (24, 48, 96):
            convs += [SameConv2d(c_in, feat, 3, 2), SameConv2d(feat, feat, 3, 1)]
            c_in = feat
        self.convs = nn.ModuleList(convs)
        self.dense = nn.ModuleList([nn.Linear(96, 128), nn.Linear(128, num_classes)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32) * f32(1.0 / 255.0) - f32(0.5)
        x = x.permute(0, 3, 1, 2)
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.mean(dim=(2, 3))
        return self.dense[1](F.relu(self.dense[0](x)))


# ---------------------------------------------------------------------------
# training (the JAX package's scripts/train_flow_cnn.py drives its version)
# ---------------------------------------------------------------------------


def _make_optimizer(model: nn.Module, lr: float, total_steps: int):
    """optax.adam(optax.cosine_decay_schedule(lr, total_steps)): Adam with
    optax's defaults (betas 0.9, 0.999, eps 1e-8) and the cosine decay to 0
    (alpha 0), stepped after each update."""
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def cosine(step: int) -> float:
        t = min(step, total_steps) / total_steps
        return 0.5 * (1 + math.cos(math.pi * t))

    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine)


def _train_epoch(model, opt, sched, xs, ys, flips) -> float:
    """One epoch: for each step s, the batch xs[s] [B, 50, 50, 3] with its
    rows flipped horizontally where flips[s] [B] is true, the softmax cross
    entropy against ys[s], one Adam update, one schedule step. Returns the
    mean of the steps' batch accuracies."""
    accs = []
    for xb, yb, fb in zip(xs, ys, flips):
        xb = xb.to(torch.float32)
        xb = torch.where(fb[:, None, None, None], xb.flip(2), xb)
        logits = model(xb)
        loss = F.cross_entropy(logits, yb)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        sched.step()
        accs.append((logits.detach().argmax(-1) == yb).to(torch.float32).mean())
    return float(torch.stack(accs).mean())


def train_flow_cnn(
    images: np.ndarray,
    labels: np.ndarray,
    epochs: int = 120,
    batch: int = 64,
    lr: float = 3e-3,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Train FlowCellNet on [N, 50, 50, 3] uint8 BGR crops and int labels →
    (model, final epoch's train accuracy). The initialisation and the flips
    come from torch generators seeded by `seed` (epoch e flips with seed
    seed·1000 + e), the shuffle from numpy's `default_rng(seed)`, as the
    JAX package's draws do from its keys."""
    dev = resolve_device(device)
    model = flax_init_(FlowCellNet(), torch.Generator().manual_seed(seed)).to(dev)
    steps_per_epoch = len(images) // batch
    opt, sched = _make_optimizer(model, lr, epochs * steps_per_epoch)
    n = steps_per_epoch * batch
    rng = np.random.default_rng(seed)
    images_t = torch.as_tensor(images).to(dev)
    labels_t = torch.as_tensor(labels).to(dev, torch.int64)
    acc = 0.0
    for e in range(epochs):
        order = torch.from_numpy(rng.permutation(len(images))[:n]).to(dev)
        flips = torch.rand(steps_per_epoch, batch, generator=torch.Generator().manual_seed(seed * 1000 + e)) < 0.5
        acc = _train_epoch(
            model, opt, sched,
            images_t[order].reshape(-1, batch, CELL, CELL, 3), labels_t[order].reshape(-1, batch),
            flips.to(dev),
        )
    return model, acc


def save_params(model: FlowCellNet, path: str = _WEIGHTS) -> None:
    """Write the model's parameters as the JAX package saves them: an npz
    keyed like `jax.tree_util.keystr` of the flax params."""
    np.savez_compressed(path, **convert.to_flax_params(model))


def load_params(path: str = _WEIGHTS, device: str | torch.device = "cuda") -> FlowCellNet:
    """FlowCellNet on `device`, in eval mode, with the parameters of the npz
    at `path` (default: the committed weights)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} missing: train FlowCellNet and save_params it first")
    model = FlowCellNet()
    with np.load(path) as data:
        model.load_state_dict(convert.from_flax_params("FlowCellNet", dict(data)))
    return model.to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# inference: classification (top-k) and sliding-window detection
# ---------------------------------------------------------------------------


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def _probs(model: FlowCellNet, cells: torch.Tensor) -> torch.Tensor:
    return torch.softmax(model(cells.to(_device(model), torch.float32)), dim=-1)


def classify_cells(model: FlowCellNet, cells) -> np.ndarray:
    """[N, 50, 50, 3] BGR uint8 → [N, num_classes] probabilities, computed
    on the model's device."""
    return _probs(model, torch.as_tensor(cells)).cpu().numpy()


def top_k_labels(probs: np.ndarray, k: int = 2):
    """The GoogLeNet demo's output rows (`deep_learning_with_opencv.py:
    29-33`): [(rank, label, prob)] sorted by probability."""
    p = np.asarray(probs).ravel()
    idxs = np.argsort(p)[::-1][:k]
    return [(r + 1, CLASS_NAMES[i], float(p[i])) for r, i in enumerate(idxs)]


def _window_probs(model: FlowCellNet, image, stride: int = 25, positive_class: int = 1):
    """Every 50×50 window of the [H, W, 3] frame at `stride`, row-major, in
    one batched forward on the model's device → (ys, xs, probs [n] of
    `positive_class`, on that device). Windows of a frame smaller than 50
    on an axis span the frame on that axis."""
    img = torch.as_tensor(image).to(_device(model))
    h, w = img.shape[:2]
    wh, ww = min(h, CELL), min(w, CELL)
    ys = list(range(0, h - wh + 1, stride))
    xs = list(range(0, w - ww + 1, stride))
    win = img.unfold(0, wh, stride).unfold(1, ww, stride)  # [ny, nx, 3, wh, ww]
    win = win.permute(0, 1, 3, 4, 2).reshape(-1, wh, ww, 3)
    return ys, xs, _probs(model, win)[:, positive_class]


def detect_windows(
    model: FlowCellNet,
    image: np.ndarray,
    stride: int = 25,
    confidence: float = 0.9,
    iou: float = 0.3,
    positive_class: int = 1,
):
    """Confidence-filtered boxes over one BGR frame, SSD-demo style
    (`deep_learning_object_detection.py:28-38`): every 50×50 window at
    `stride` is scored in ONE batched forward, windows above `confidence`
    on `positive_class` go through the host NMS.

    Returns [(label, confidence, (x1, y1, x2, y2))]."""
    ys, xs, probs = _window_probs(model, image, stride, positive_class)
    probs = probs.cpu().numpy()
    boxes, scores = [], []
    for i, (y, x) in enumerate((y, x) for y in ys for x in xs):
        if probs[i] > confidence:
            boxes.append((x, y, x + CELL, y + CELL))
            scores.append(float(probs[i]))
    if not boxes:
        return []
    kept = non_max_suppression(np.asarray(boxes, np.int32), iou)
    score_of = dict(zip(boxes, scores))
    return [
        (CLASS_NAMES[positive_class], score_of[tuple(int(v) for v in b)], tuple(int(v) for v in b))
        for b in kept
    ]
