"""The fused dp×sp train step: pipeline features and a classifier update
(port of `opticalflowclustering_tpu/parallel/train.py`).

Over a ('dp', 'sp') mesh:
  dp — splits the video batch
  sp — splits each video's frame axis, with the one-frame ring halo of
       parallel/temporal.py (`_block_grays`)

Each block, on its device: gray → Farneback flow → HSV render → grid cells
→ dominant hue rows → classifier forward and backward, with the block's
activations kept on its device. The gradients and the loss are the mean
over the blocks (JAX: `pmean` over dp, then over sp), and one optimizer
update is applied to the model, so every block of the next step sees the
same parameters.

The ring wraps as in the JAX package: the last sp block pairs its last frame
with frame 0 of the video, and that wrapped pair is part of the loss, since
the labels are [B, N].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call

from opticalflowclustering_tpu_torch.features.dominant_color import dominant_hue_k1_frames
from opticalflowclustering_tpu_torch.features.grid import GridParams
from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams, farneback_flow
from opticalflowclustering_tpu_torch.flow.render import render_flow_hsv_bgr
from opticalflowclustering_tpu_torch.parallel.mesh import Mesh
from opticalflowclustering_tpu_torch.parallel.temporal import _block_grays, _split


@torch.no_grad()
def _local_hue_features(gray_ext: torch.Tensor, grid: GridParams, params: FarnebackParams) -> torch.Tensor:
    """A block's gray frames with their halo [b, n+1, H, W] → the dominant
    hue rows of its n pairs [b, n, cells] float32, on the block's device."""
    flow = farneback_flow(gray_ext[:, :-1], gray_ext[:, 1:], params)
    _, hue = dominant_hue_k1_frames(render_flow_hsv_bgr(flow), grid)
    return hue.to(torch.float32)


def make_fused_train_step(
    mesh: Mesh,
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    grid: GridParams = GridParams(4, 6),
    flow_params: FarnebackParams = FarnebackParams(),
    dp_axis: str = "dp",
    sp_axis: str = "sp",
):
    """Build the sharded end-to-end train step
    `step(videos [B, N, H, W, 3] u8, labels [B, N]) → loss`: videos and labels
    split (dp, sp) over the mesh, the classifier's parameters copied to each
    block's device at the start of the step; `optimizer` holds `model`'s
    parameters and takes one update per step. The loss is a 0-d tensor on
    the model's device. With `FarnebackParams(warp_mode='fast')` every
    block's flow launches the warp_m and box_solve kernels."""
    devs = mesh.axis_devices(dp_axis, sp_axis)
    dp, sp = devs.shape
    home = next(model.parameters()).device

    def step(videos, labels) -> torch.Tensor:
        v = torch.as_tensor(videos)
        y_all = torch.as_tensor(labels)
        b_loc = _split(v.shape[0], dp, "a batch")
        n_loc = _split(v.shape[1], sp, "a frame axis")
        replicas: dict[torch.device, dict[str, torch.Tensor]] = {}
        losses = [[None] * sp for _ in range(dp)]
        grads = [[None] * sp for _ in range(dp)]
        for i, j, gray_ext in _block_grays(v, devs):
            dev = devs[i, j]
            feats = _local_hue_features(gray_ext, grid, flow_params)
            b, n, d = feats.shape
            x = feats.reshape(b * n, d)
            y = y_all[i * b_loc : (i + 1) * b_loc, j * n_loc : (j + 1) * n_loc]
            y = y.to(dev, torch.float32).reshape(b * n)
            if dev not in replicas:
                replicas[dev] = {k: p.detach().to(dev).requires_grad_() for k, p in model.named_parameters()}
            params = replicas[dev]
            loss = F.binary_cross_entropy_with_logits(functional_call(model, params, (x,)), y)
            g = torch.autograd.grad(loss, list(params.values()))
            losses[i][j] = loss.detach().to(home)
            grads[i][j] = [t.to(home) for t in g]

        def block_mean(per_block):
            # JAX: pmean over dp, then over sp
            return torch.stack([torch.stack([per_block[i][j] for i in range(dp)]).mean(0)
                                for j in range(sp)]).mean(0)

        for k, p in enumerate(model.parameters()):
            p.grad = block_mean([[grads[i][j][k] for j in range(sp)] for i in range(dp)])
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        return block_mean(losses)

    return step
