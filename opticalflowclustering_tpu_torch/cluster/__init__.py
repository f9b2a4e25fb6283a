"""Signature matching (port of opticalflowclustering_tpu.cluster)."""
