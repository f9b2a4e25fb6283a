"""Hand-written CUDA kernels for Hopper, their one build and their plain
PyTorch versions: warp.py (warp+M, box-solve) and probes.py (the
gather-cost probes)."""
