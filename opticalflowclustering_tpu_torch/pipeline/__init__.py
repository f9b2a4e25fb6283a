"""The bounce-feature pipeline (port of opticalflowclustering_tpu.pipeline)."""
