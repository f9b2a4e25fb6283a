"""Signature matching and k-means (port of opticalflowclustering_tpu.cluster)."""
