"""Device meshes, the dp×sp split of the pipeline over them, and the
multi-process layer (port of opticalflowclustering_tpu.parallel)."""
