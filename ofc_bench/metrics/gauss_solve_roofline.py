"""gauss_solve_roofline: the Gaussian-solve kernel's share of its roofline
over the traced launches, against the work the configuration asks of it
(`yardstick_gauss.roofline_pct`). Layer: kernels. None where no launch is
named `gauss_solve_kernel`, as for a program that runs the window plain."""

from ofc_bench.yardstick_gauss import roofline_pct


def read(view):
    return roofline_pct(view)
