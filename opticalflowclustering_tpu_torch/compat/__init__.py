"""Byte-compatible output-contract writers (port of opticalflowclustering_tpu.compat)."""
