"""poly_host_ms_per_pair: the driving thread's time inside the `ofc.flow.poly`
spans (the launches of the polynomial expansion of every pyramid level, each
image, and any wait on the card they meet), clipped to the traced window, in
ms per flow pair. Where the driving thread never waits on the card at a
readback, its time is the pace of the loop, so this is the stage's share of
`pair_ms`; `poly_ms_per_pair` is the card's. Layer: flow stages. None where
the program opens no `ofc.flow.poly` span."""

from ofc_bench.spans import host_ms_per_pair


def read(view):
    return host_ms_per_pair(view, "ofc.flow.poly")
