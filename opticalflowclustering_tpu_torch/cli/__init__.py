"""Command-line entry points (port of opticalflowclustering_tpu.cli)."""
