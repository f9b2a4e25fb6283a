"""Multi-process scale-out on `torch.distributed` (port of
`opticalflowclustering_tpu/parallel/multihost.py`).

  * `initialize(...)` — `torch.distributed.init_process_group` from explicit
    arguments or the standard MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK
    variables: NCCL where the devices are CUDA, gloo on the CPU.
  * `host_shard(...)` — a deterministic round-robin partition of a video
    list across processes: each process decodes and processes only its own
    videos, so no raw frame crosses processes.
  * `global_mesh(...)` — a dp×sp Mesh over every process's devices,
    dp-major across processes, so each video's temporal halo stays within
    one process and only whole videos are split across processes.
  * `local_submesh(...)` — this process's whole dp rows of such a mesh.

As in the JAX package, nothing crosses processes while videos are
processed: building the global mesh gathers each process's device names
once, and the queue then runs each process's share on its own rows.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from opticalflowclustering_tpu_torch.parallel.mesh import Mesh, cuda_devices, device_array
from opticalflowclustering_tpu_torch.runtime import resolve_device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
) -> None:
    """Join the process group. `coordinator_address` is "host:port" of rank
    0; each argument left None falls back to MASTER_ADDR:MASTER_PORT,
    WORLD_SIZE and RANK. The backend is NCCL when `device` is CUDA (which
    raises where CUDA is absent) and gloo when it is the CPU."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    n = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    pid = process_id if process_id is not None else os.environ.get("RANK")
    if addr is None or n is None or pid is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of processes "
            "and this process's id (or MASTER_ADDR/MASTER_PORT, WORLD_SIZE, RANK)"
        )
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend,
        init_method=f"tcp://{addr}",
        world_size=int(n),
        rank=int(pid),
    )


def process_index() -> int:
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes (1 outside a process group)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def host_shard(items: list, process_id: int | None = None, num_processes: int | None = None) -> list:
    """The items this process owns: a deterministic round-robin, so every
    process computes the same assignment without communicating."""
    pid = process_index() if process_id is None else process_id
    n = process_count() if num_processes is None else num_processes
    return [it for i, it in enumerate(items) if i % n == pid]


def global_mesh(sp: int | None = None, axis_names=("dp", "sp"), local_devices=None) -> Mesh:
    """dp×sp Mesh over every process's devices, process-major, so each sp
    group (a video's halo ring) lies within one process whenever sp divides
    the per-process device count. `local_devices`: this process's devices
    (default: every visible CUDA device, raising where there is none; a CPU
    run may name the CPU several times). In a process group the device
    names are gathered from every process once, here."""
    local = [str(d) for d in (cuda_devices() if local_devices is None else local_devices)]
    if process_count() > 1:
        per_process: list = [None] * process_count()
        dist.all_gather_object(per_process, local)
    else:
        per_process = [local]
    names = [d for devs in per_process for d in devs]
    owners = [r for r, devs in enumerate(per_process) for _ in devs]
    if sp is None:
        sp = len(local)
    if len(names) % sp:
        raise ValueError(f"{len(names)} devices not divisible by sp={sp}")
    shape = (len(names) // sp, sp)
    return Mesh(device_array(names).reshape(shape), axis_names, np.array(owners).reshape(shape))


def local_submesh(mesh: Mesh, dp_axis: str = "dp") -> Mesh:
    """This process's slice of a dp-major global mesh: the dp rows whose
    devices are all its own, as a Mesh with the same axis names, which its
    host-local frames can drive with no cross-process exchange.

    Every dp row must be entirely local or entirely remote (true for any
    `global_mesh` whenever sp divides the per-process device count); a row
    mixing processes would strand its local devices, so it raises. A mesh
    without owners is this process's already and passes through."""
    if mesh.owners is None:
        return mesh
    pid = process_index()
    di = mesh.axis_names.index(dp_axis)
    devs = np.moveaxis(mesh.devices, di, 0)
    owners = np.moveaxis(mesh.owners, di, 0)
    rows = owners.reshape(owners.shape[0], -1)
    local = (rows == pid).all(axis=1)
    mixed = [r for r in range(rows.shape[0]) if not local[r] and (rows[r] == pid).any()]
    if mixed:
        raise ValueError(
            f"mesh rows {mixed} along {dp_axis!r} mix local and remote "
            "devices; build the mesh dp-major across processes "
            "(e.g. multihost.global_mesh) so each process owns whole dp rows"
        )
    keep = np.flatnonzero(local)
    if keep.size == 0:
        raise ValueError(f"process {pid} owns no complete {dp_axis!r} row of the mesh")
    return Mesh(
        np.moveaxis(devs[keep], 0, di), mesh.axis_names, np.moveaxis(owners[keep], 0, di)
    )
