"""Device meshes, the dp×sp split of the pipeline over them, the row split
of one frame's flow, and the multi-process layer (port of
opticalflowclustering_tpu.parallel)."""

from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh
from opticalflowclustering_tpu_torch.parallel.spatial import (
    spatial_farneback_flow,
    spatial_farneback_flow_padded,
    spatial_hue_pipeline,
)
from opticalflowclustering_tpu_torch.parallel.temporal import (
    sharded_hue_pipeline,
    sharded_hue_pipeline_videos,
    temporal_shard_flow,
)

__all__ = [
    "make_mesh",
    "sharded_hue_pipeline",
    "sharded_hue_pipeline_videos",
    "spatial_farneback_flow",
    "spatial_farneback_flow_padded",
    "spatial_hue_pipeline",
    "temporal_shard_flow",
]
