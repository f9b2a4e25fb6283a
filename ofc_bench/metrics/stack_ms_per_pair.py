"""stack_ms_per_pair: the host time spent laying frames out for the card:
`_stack_chunks`, the stream's copy into its pinned slot (with its wait for
the slot's last upload), the native stream's batches, the queue's `np.stack`
and pad, in ms per flow pair: the driving thread's `ofc.stack` spans,
clipped to the traced window. Layer: pipeline loop copies. None where the
program opens no `ofc.stack` span."""

from ofc_bench.spans import host_ms_per_pair


def read(view):
    return host_ms_per_pair(view, "ofc.stack")
