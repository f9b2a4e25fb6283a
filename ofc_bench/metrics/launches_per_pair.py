"""launches_per_pair: CUDA kernels in the traced window per flow pair.
Layer: host dispatch (the eager operators of `flow/`, `features/` and the
chunk loop of `pipeline/bounce.py`)."""


def read(view):
    kernels = view.kernels()
    if not kernels or not view.pairs:
        return None
    return len(kernels) / view.pairs
