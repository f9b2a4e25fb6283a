"""Hand-written CUDA kernels for Hopper, their one build and their plain
PyTorch versions: warp.py (warp+M, the box and Gaussian solves), poly.py
(the polynomial expansion), pyramid.py (a pyramid level's blur and
downsample) and probes.py (the gather-cost probes).

Each flow kernel has one entry in its module, named after its launch key:
it launches the kernel (`*_cuda`) where `on_card` holds for its input and
the gate beside it (`*_takes`) takes the shapes and parameters, and runs the
plain version (`*_reference`) everywhere else. The launchers check their
inputs and count each launch in `LAUNCHES`, the one launch registry.
"""

# The kernels the flow runs; the probes' come after them in `LAUNCHES`.
FLOW_KERNELS = ("warp_m", "box_solve", "gauss_solve", "poly_expansion", "pyramid")
# Launches per kernel since the last `reset_launches`.
LAUNCHES = dict.fromkeys(FLOW_KERNELS + ("loop_probe", "dynslice"), 0)


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flow_launches() -> dict:
    """The five flow kernels' launch counts."""
    return {k: LAUNCHES[k] for k in FLOW_KERNELS}


def on_card(t) -> bool:
    """Whether the flow kernels' entries may launch on tensor t: it is on a
    CUDA card. The tests' CPU rehearsal of the card's path replaces it."""
    return t.is_cuda
