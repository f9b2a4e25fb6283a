"""poly_ms_per_pair: the device time of the polynomial expansion of every
pyramid level, each image, in ms per flow pair: every kernel, copy and fill
launched inside an `ofc.flow.poly` span, summed over the cards. Layer: flow
stages (`flow/farneback.farneback_flow`). None where the program opens no
`ofc.flow.poly` span."""

from ofc_bench.spans import device_ms_per_pair


def read(view):
    return device_ms_per_pair(view, "ofc.flow.poly")
