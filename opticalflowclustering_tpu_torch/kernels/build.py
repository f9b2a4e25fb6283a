"""One build for all of the port's CUDA kernels.

Every source in `csrc/` goes into one `torch.utils.cpp_extension.load` call,
so ninja compiles them in parallel and the extension is loaded once. Only
`bindings.cpp` includes PyTorch's headers (a translation unit with
`torch/extension.h` takes minutes to compile); each `.cu` file exposes a
plain C launcher. The build goes to `<repo>/.torch_ext_build/` at first use
and is compiled with `--fmad=false`: without multiply-add contraction the
kernels run the same float32 operations in the same order as their plain
PyTorch versions, so the two agree bit for bit. A build that fails raises.
"""

from __future__ import annotations

import functools
import pathlib

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / ".torch_ext_build"
SOURCES = ("bindings.cpp", "warp_m.cu", "box_solve.cu", "gauss_solve.cu", "poly_expansion.cu", "pyramid.cu", "probes.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false")


@functools.cache
def build(verbose: bool = False):
    """Compile (or load the cached build of) the kernels' extension."""
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return load(
        name="ofc_torch_kernels",
        sources=[str(CSRC / s) for s in SOURCES],
        build_directory=str(BUILD_DIR),
        extra_cflags=["-O2"],
        extra_cuda_cflags=list(NVCC_FLAGS),
        verbose=verbose,
    )
