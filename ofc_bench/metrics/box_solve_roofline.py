"""box_solve_roofline: the box_solve kernel's share of its roofline over the
traced launches, against the work the configuration asks of it
(`yardstick.roofline_pct`). Layer: kernels."""

from ofc_bench.yardstick import roofline_pct


def read(view):
    return roofline_pct(view, "box_solve")
