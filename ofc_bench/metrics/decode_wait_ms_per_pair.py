"""decode_wait_ms_per_pair: the time the driving thread waited for decoded
frames (the prefetch thread's queue, the native decoder's window, the
queue's decode thread), in ms per flow pair: the driving thread's
`ofc.decode.wait` spans, clipped to the traced window. Layer: decode thread
(`io/video.prefetch_chunks`, `io/fastio.stream_mjpeg_avi`, the decode thread
of `pipeline/queue.py`). None where the program opens no `ofc.decode.wait`
span."""

from ofc_bench.spans import host_ms_per_pair


def read(view):
    return host_ms_per_pair(view, "ofc.decode.wait")
