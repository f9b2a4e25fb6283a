"""The CNN inference slot (port of `opticalflowclustering_tpu/models/cnn.py`):
the replacement of the reference's cv2.dnn Caffe pipelines
(`deep-learning-with-opencv/deep_learning_with_opencv.py:17-33` GoogLeNet
classification, `object-detection-with-deep-learning-and-opencv/
deep_learning_object_detection.py:12-38` MobileNet-SSD detection).

The same preprocessing (`blobFromImage`), a forward on the card, the same
postprocessing (top-k, confidence-filtered scaled boxes). The blob is NCHW,
as cv2.dnn's is; the convolutions pad flax's 'SAME' way (models/layers.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from opticalflowclustering_tpu_torch import convert
from opticalflowclustering_tpu_torch.models.layers import SameConv2d, flax_init_
from opticalflowclustering_tpu_torch.ops.resize import resize_linear_hwc
from opticalflowclustering_tpu_torch.runtime import f32, resolve_device

VOC_CLASSES = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
]


def blob_from_image(
    image: torch.Tensor,
    scalefactor: float = 1.0,
    size: tuple[int, int] = (224, 224),
    mean: tuple[float, float, float] = (0.0, 0.0, 0.0),
    swap_rb: bool = False,
) -> torch.Tensor:
    """cv2.dnn.blobFromImage: [H, W, 3] → resize (bilinear, cv2-exact) →
    mean-subtract → scale → NCHW [1, 3, h, w] float32, on the image's device.
    `size` is (w, h), as cv2 takes it."""
    img = torch.as_tensor(image).to(torch.float32)
    w, h = size
    img = resize_linear_hwc(img, (h, w))
    if swap_rb:
        img = img.flip(-1)
    img = (img - torch.tensor(mean, dtype=torch.float32, device=img.device)) * f32(scalefactor)
    return img.permute(2, 0, 1)[None]


class SmallCNN(nn.Module):
    """Compact ConvNet for the classification slot: NCHW blob → logits
    [B, num_classes]; three stride-2 3×3 convs (32, 64, 128) with ReLU, the
    mean over H and W, Dense 256 with ReLU, Dense num_classes."""

    def __init__(self, num_classes: int = 1000):
        super().__init__()
        self.convs = nn.ModuleList(
            [SameConv2d(3, 32, 3, 2), SameConv2d(32, 64, 3, 2), SameConv2d(64, 128, 3, 2)])
        self.dense = nn.ModuleList([nn.Linear(128, 256), nn.Linear(256, num_classes)])

    def forward(self, blob_nchw: torch.Tensor) -> torch.Tensor:
        x = blob_nchw
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.mean(dim=(2, 3))
        return self.dense[1](F.relu(self.dense[0](x)))


class ClassifierNet:
    """The `readNetFromCaffe → setInput → forward` flow
    (`deep_learning_with_opencv.py:17-23`) with a PyTorch model inside, on
    `device`. `params`: the JAX package's flax parameters of the model (a
    pytree or a keystr-keyed flat mapping, through convert.from_flax_params);
    None initialises it flax's way from a generator seeded `seed`."""

    def __init__(self, model: nn.Module | None = None, params=None, num_classes: int = 1000,
                 seed: int = 0, device: str | torch.device = "cuda"):
        model = model or SmallCNN(num_classes=num_classes)
        if params is None:
            flax_init_(model, torch.Generator().manual_seed(seed))
        else:
            model.load_state_dict(convert.from_flax_params(type(model).__name__, params))
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self._blob = None

    def set_input(self, blob) -> None:
        self._blob = torch.as_tensor(blob)

    @torch.inference_mode()
    def forward(self) -> np.ndarray:
        return self.model(self._blob.to(self.device, torch.float32)).cpu().numpy()


def top_k(preds: np.ndarray, k: int = 5) -> list[tuple[int, float]]:
    """`deep_learning_with_opencv.py:29-33`: top-k (class, prob) pairs."""
    p = np.asarray(preds).ravel()
    idxs = np.argsort(p)[::-1][:k]
    return [(int(i), float(p[i])) for i in idxs]


def filter_detections(
    detections: np.ndarray,
    image_hw: tuple[int, int],
    confidence: float = 0.2,
) -> list[tuple[int, float, tuple[int, int, int, int]]]:
    """SSD postprocess (`deep_learning_object_detection.py:28-38`):
    detections [1,1,N,7] rows (_, class, conf, x1, y1, x2, y2 normalized) →
    [(class, conf, (x1,y1,x2,y2) pixels)] above the confidence floor."""
    h, w = image_hw
    out = []
    for det in np.asarray(detections).reshape(-1, 7):
        conf = float(det[2])
        if conf > confidence:
            box = det[3:7] * np.array([w, h, w, h])
            out.append((int(det[1]), conf, tuple(box.astype(int))))
    return out
