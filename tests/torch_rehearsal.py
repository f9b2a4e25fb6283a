"""The port's CPU rehearsal of the card's kernel path. Test files import
the fixture by name; it is not in `conftest.py`, which imports JAX and which
the card's test runs leave out (`--noconftest`)."""

import pytest


@pytest.fixture
def kernel_path_on_cpu(monkeypatch):
    """The card's path through the five flow kernels on CPU tensors: each
    entry's gate alone picks kernel or plain version, and each launcher runs
    its plain version and counts the launch in `kernels.LAUNCHES`. Returns
    `launch(name, fn)`, which makes kernel `name`'s launcher run fn."""
    from opticalflowclustering_tpu_torch import kernels
    from opticalflowclustering_tpu_torch.kernels import poly, pyramid, warp

    modules = {"warp_m": warp, "box_solve": warp, "gauss_solve": warp, "poly_expansion": poly, "pyramid": pyramid}

    def launch(name, fn):
        def counted(*args):
            kernels.LAUNCHES[name] += 1
            return fn(*args)

        monkeypatch.setattr(modules[name], f"{name}_cuda", counted)

    monkeypatch.setattr(kernels, "on_card", lambda t: True)
    for name, mod in modules.items():
        launch(name, getattr(mod, f"{name}_reference"))
    return launch


def rehearse_phase(monkeypatch, launch, name, fn):
    """chip_smoke's phase of kernel `name` on the CPU: its launcher runs fn,
    counted (`launch`, from `kernel_path_on_cpu`), the CUDA-event timer is
    one host-clocked call, and the counts start at 0. Returns chip_smoke."""
    import time

    import chip_smoke
    from opticalflowclustering_tpu_torch import kernels

    def host_ms(fn, iters):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3

    launch(name, fn)
    monkeypatch.setattr(chip_smoke, "loop_ms", host_ms)
    kernels.reset_launches()
    return chip_smoke
