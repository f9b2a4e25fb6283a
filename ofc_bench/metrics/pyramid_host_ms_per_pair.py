"""pyramid_host_ms_per_pair: the driving thread's time inside the
`ofc.flow.pyramid` spans (the launches of every level's blur and resize,
each image), clipped to the traced window, in ms per flow pair: the host's
side of `pyramid_ms_per_pair`, as `poly_host_ms_per_pair` is of
`poly_ms_per_pair`. Layer: flow stages. None where the program opens no
`ofc.flow.pyramid` span."""

from ofc_bench.spans import host_ms_per_pair


def read(view):
    return host_ms_per_pair(view, "ofc.flow.pyramid")
