"""Device meshes (port of `opticalflowclustering_tpu/parallel/mesh.py`).

A mesh lays devices out on named axes, named for the parallelism they carry:

  dp — across videos (independent)
  sp — across a video's frame axis (temporal sharding; the flow needs a
       one-frame halo from the next block, `parallel/temporal.py`)

The port's mesh is a plain object: a numpy object array of `torch.device`s
and the axis names, plus, for a mesh that spans processes
(`parallel/multihost.global_mesh`), the rank that owns each entry. The
programs that run over it are ordinary per-device PyTorch calls issued by
one process. A mesh may name the same device more than once: that lays a
2×2 layout over one card or over the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from opticalflowclustering_tpu_torch.runtime import resolve_device


def device_array(devices) -> np.ndarray:
    """A 1-D numpy object array of `torch.device`s from any iterable of
    devices or device names."""
    devs = [torch.device(d) for d in devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return arr


class Mesh:
    """`devices`: an object array of `torch.device`s, one axis per name in
    `axis_names`. `owners`: an int array of the same shape, the rank of the
    process that owns each entry (None: every entry is this process's)."""

    def __init__(self, devices: np.ndarray, axis_names, owners: np.ndarray | None = None):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-d device array for axes {self.axis_names}"
            )
        if owners is not None and np.shape(owners) != self.devices.shape:
            raise ValueError(f"owners {np.shape(owners)} vs devices {self.devices.shape}")
        self.owners = None if owners is None else np.asarray(owners, dtype=np.int64)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, *axes: str) -> np.ndarray:
        """The devices laid out along `axes`, in that order, at index 0 of
        every other axis (a program sharded over `axes` alone is replicated
        over the others)."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(self.devices.ndim) if i not in idx]
        arr = np.transpose(self.devices, idx + rest)
        return arr[(Ellipsis,) + (0,) * len(rest)] if rest else arr

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA device; raises where CUDA is absent."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a Mesh. Default devices: every visible CUDA device (raising
    where there is none); default axes: all of them on one 'sp' axis.

    make_mesh({'dp': 2, 'sp': 4}) → a 2×4 mesh of 8 devices. An axis size of
    -1 absorbs the remaining devices; surplus devices are left out."""
    devs = device_array(cuda_devices() if devices is None else devices)
    if axes is None:
        axes = {"sp": len(devs)}
    names = list(axes)
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError(f"at most one axis may be -1: {axes}")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = len(devs) // known
    total = int(np.prod(sizes))
    if total > len(devs) or total < 1:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {total} devices; {len(devs)} given")
    return Mesh(devs[:total].reshape(sizes), names)
