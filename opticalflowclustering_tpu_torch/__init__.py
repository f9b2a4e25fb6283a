"""opticalflowclustering_tpu_torch — the PyTorch/CUDA port of
opticalflowclustering_tpu for one NVIDIA H100.

The JAX package beside it is the reference: every module here mirrors the
JAX module of the same path and is tested against it on the CPU. The two
Pallas kernels of the Farneback inner loop and the four Pallas probe kernels
of the gather-cost microbenchmarks become hand-written CUDA kernels for
sm_90a (kernels/csrc/), built at first use in one build; every other stage
is plain PyTorch on the device the caller names.

Layout (mirrors the JAX package):
  runtime.py  device selection and the float32 policy
  ops/        cv2-exact colorspace, filters, resize, polar; LAB
  flow/       Farneback dense optical flow and the HSV flow render
  kernels/    the CUDA kernels (warp+M, box-solve, the probes), their build
              and their plain versions
  features/   grid pooling and the per-cell dominant colour
  cluster/    the sliding-window signature matcher; k-means (Lloyd, ++,
              MiniBatchKMeans, batched)
  models/     FlowCellNet (with its committed weights), the cv2.dnn slot's
              SmallCNN, the bounce classifier; flax's 'SAME' convolution
  pipeline/   the bounce-feature pipeline (chunk_step, process_frames,
              process_video_stream) and the multi-video queue
  parallel/   device meshes, the dp×sp split of the pipeline, the fused
              dp×sp train step, and the multi-process layer on
              torch.distributed
  extras/     colour quantization, non-maximum suppression
  io/         video decode and encode on the host, the prefetch thread,
              the real-time VideoStream, image-tree readers, and the ctypes
              boundary to the native decoder (fastio)
  native/     the C++ host-IO runtime (MJPEG-AVI and PNG decode with no
              codec library), built with g++ at first use
  compat/     byte-compatible CSV writers
  cli/        kmeangrids, computeopticalflow, findcosine, processqueue,
              colorkmeans, classify, detect, realtime, trainbounce,
              drawgrids, vectordistance
  scripts/    the probe scripts (gather_cost_probe, profile_r4) and the
              bench clips
  utils/      timing and tracing (StageTimer, ThroughputMeter, the
              pipeline's `ofc.*` spans, trace_to, CUDA-event timers) and
              logging
  convert.py  carries configs, constant tables and flax parameters across
              from the JAX side

This package imports torch, numpy and (inside the functions that decode,
encode or draw) cv2; it never imports jax.
"""

__version__ = "0.1.0"
