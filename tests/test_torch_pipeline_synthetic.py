"""PyTorch port vs the JAX package end to end on a synthetic clip
(opticalflowclustering_tpu_torch.pipeline.bounce.process_frames ↔
opticalflowclustering_tpu.pipeline.bounce.process_frames), with the
tolerances of test_torch_pipeline.py. A file of its own so that the JAX
side's per-shape eager compiles run on another test worker."""

import numpy as np
import pytest
import torch

from opticalflowclustering_tpu_torch.scripts.clips import synth_frames
from test_torch_pipeline import _e2e

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["fast", "fast16"])
def test_process_frames_matches_jax_on_synthetic_clip(mode):
    """The numpy-made bench clip (scripts.clips; blurred noise, a moving
    disc) at 9 frames of 144×200."""
    got = _e2e(synth_frames(9, 144, 200), mode)
    assert np.isfinite(got["mean_magnitude"]).all() and got["mean_magnitude"].max() > 0.01
