"""gauss_ms_per_pair: the device time of the Gaussian-window solves of every
pyramid level and iteration, in ms per flow pair: every kernel, copy and
fill launched inside an `ofc.flow.gauss` span, summed over the cards.
Layer: flow stages (`flow/farneback.farneback_flow`). None where the
program opens no `ofc.flow.gauss` span."""

from ofc_bench.spans import device_ms_per_pair


def read(view):
    return device_ms_per_pair(view, "ofc.flow.gauss")
