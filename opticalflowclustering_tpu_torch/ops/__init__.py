"""cv2-exact image primitives in PyTorch (port of opticalflowclustering_tpu.ops)."""
