"""Farneback dense optical flow and its HSV render (port of opticalflowclustering_tpu.flow)."""
