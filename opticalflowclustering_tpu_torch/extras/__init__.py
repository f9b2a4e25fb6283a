"""Library ports of the reference's auxiliary workloads: colour quantization
and non-maximum suppression (port of opticalflowclustering_tpu.extras)."""
