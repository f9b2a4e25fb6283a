"""queue_clip_p90_ms: the 90th percentile, over the clips that the traced
requests finished, of the host-clock time from a request's submission to
the clip's tables (for the queue: its artifact written). Layer: queue
(`pipeline/queue.py`, its decode thread and the blocks it issues to the
cards). It is `clip_p90_ms` of the queue cell, where that number spreads too
widely between runs to hold a bound end to end."""

import numpy as np


def read(view):
    if not view.clip_ms:
        return None
    return float(np.percentile(view.clip_ms, 90))
