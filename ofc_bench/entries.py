"""The program's entries that a traffic mix can drive, by the mix's "entry".

Each entry takes one request of the closed loop (`submit`): a clip, or for
the queue a folder of clips, handed to the port the way its CLI hands it,
and returns one `Done` per clip with the host-clock times of its submission
and of its tables reaching the host (for the queue: its artifact written).
Only the port's public calls are made here; nothing of the program is
patched or read besides what those calls return.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections.abc import Callable

import numpy as np

from ofc_bench import clips as clipgen


@dataclasses.dataclass
class Done:
    clip: int
    submitted: float  # time.time() seconds
    finished: float
    pairs: int
    ok: bool
    load: Callable[[], dict[str, np.ndarray]]  # the clip's tables, as the program returned them


def pipeline_config(config: dict):
    from opticalflowclustering_tpu_torch.features.grid import GridParams
    from opticalflowclustering_tpu_torch.flow.farneback import FarnebackParams
    from opticalflowclustering_tpu_torch.pipeline.bounce import PipelineConfig

    return PipelineConfig(
        grid=GridParams(**config["grid"]),
        flow=FarnebackParams(**config["farneback"]),
        rb_swap=config["rb_swap"],
        chunk=config["chunk"],
        emit_flow_bgr=config["emit_flow_bgr"],
    )


class Entry:
    """Drives one entry over the mix's clips, held in memory or written as
    files under `workdir`."""

    files = False

    def __init__(self, config: dict, traffic: dict, clips: list[np.ndarray], workdir: str, device: str):
        self.config, self.traffic, self.clips = config, traffic, clips
        self.device = device
        self.cfg = pipeline_config(config)
        self.pairs = config["clip_frames"] - 1
        self.paths = []
        if self.files:
            for i, c in enumerate(clips):
                path = os.path.join(workdir, f"clip{i}.avi")
                clipgen.write_mjpeg_avi(path, c, traffic["file"]["quality"])
                self.paths.append(path)

    def reference_input(self, clip: int) -> np.ndarray:
        """The frames the reference gets for `clip`: the clip itself, or the
        clip's file decoded by cv2 (the same bytes the program reads)."""
        return clipgen.read_avi(self.paths[clip]) if self.files else self.clips[clip]

    def warm(self) -> None:
        self.submit(0)

    def submit(self, clip: int) -> list[Done]:
        raise NotImplementedError

    def request_clips(self, clip: int) -> list[int]:
        """The clips a request for `clip` covers."""
        return [clip]

    def _one(self, clip: int, call: Callable[[], dict]) -> list[Done]:
        t0 = time.time()
        out = call()
        t1 = time.time()
        return [Done(clip, t0, t1, self.pairs, True, lambda: out)]


class ProcessFrames(Entry):
    """`pipeline.bounce.process_frames` on a clip in host memory."""

    def submit(self, clip):
        from opticalflowclustering_tpu_torch.pipeline.bounce import process_frames

        return self._one(clip, lambda: process_frames(self.clips[clip], self.cfg, self.device))


class ProcessVideoStream(Entry):
    """`pipeline.bounce.process_video_stream` on a clip's MJPEG AVI, as
    `kmeangrids --stream` calls it."""

    files = True

    def submit(self, clip):
        from opticalflowclustering_tpu_torch.pipeline.bounce import process_video_stream

        native = bool(self.traffic.get("native", False))
        return self._one(clip, lambda: process_video_stream(self.paths[clip], self.cfg, None, native,
                                                             device=self.device))


class ProcessVideoQueueDp(Entry):
    """`pipeline.queue.process_video_queue_dp` over the folder of every
    clip's MJPEG AVI on the mix's dp × sp mesh, resume off, as `processqueue
    --dp --sp` calls it. A clip is finished when its artifact is written."""

    files = True

    def __init__(self, config, traffic, clips, workdir, device):
        super().__init__(config, traffic, clips, workdir, device)
        from opticalflowclustering_tpu_torch.parallel.mesh import make_mesh

        axes = dict(traffic["mesh"])
        n = int(np.prod(list(axes.values())))
        self.mesh = make_mesh(axes) if device.startswith("cuda") else make_mesh(axes, [device] * n)
        self.workdir = workdir
        self.requests = 0

    def warm(self):
        # One dp batch: every card's blocks at the mix's shapes.
        self._run(self.paths[: self.mesh.shape["dp"]])

    def submit(self, clip):
        return self._run(self.paths)

    def request_clips(self, clip):
        return list(range(len(self.paths)))

    def _run(self, paths: list[str]) -> list[Done]:
        from opticalflowclustering_tpu_torch.pipeline.queue import load_features, process_video_queue_dp

        # Each request writes a directory of its own, read back after the window.
        out_dir = os.path.join(self.workdir, f"artifacts{self.requests}")
        self.requests += 1
        t0 = time.time()
        results = process_video_queue_dp(paths, out_dir, self.mesh, self.cfg, resume=False)
        done = []
        for r in results:
            clip = self.paths.index(r.video)
            if r.ok:
                done.append(Done(clip, t0, os.stat(r.path).st_mtime_ns / 1e9, self.pairs, True,
                                 lambda path=r.path: load_features(path)))
            else:
                done.append(Done(clip, t0, time.time(), self.pairs, False, dict))
        return done


ENTRIES = {
    "process_frames": ProcessFrames,
    "process_video_stream": ProcessVideoStream,
    "process_video_queue_dp": ProcessVideoQueueDp,
}
