"""Grid pooling and per-cell dominant colour (port of opticalflowclustering_tpu.features)."""
