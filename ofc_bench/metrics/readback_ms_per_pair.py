"""readback_ms_per_pair: the host time spent bringing tables back: each chunk's
`.cpu().numpy()` and the final concatenate, the stream's event wait and
copy, the queue's `.cpu()` and `torch.cat` of its blocks, in ms per flow
pair: the driving thread's `ofc.readback` spans, clipped to the traced
window. Layer: pipeline loop copies. None where the program opens no
`ofc.readback` span."""

from ofc_bench.spans import host_ms_per_pair


def read(view):
    return host_ms_per_pair(view, "ofc.readback")
