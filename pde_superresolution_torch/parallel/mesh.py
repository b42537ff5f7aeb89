"""The process group and the ("data", "space") device mesh.

One process per device. Under ``torchrun`` every process reads its rank, the
world size and the rendezvous address from the environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``); a single
process started without it runs at world size 1 on a store of its own. The
backend is NCCL on ``cuda`` and gloo on the CPU, with no fallback from one
to the other.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from pde_superresolution_torch.device import resolve_device

DATA_AXIS = "data"
SPACE_AXIS = "space"

_LAUNCHER_VARIABLES = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize_multihost(device=None, **kwargs) -> None:
    """Join (or make) the default process group; call once per process,
    before any collective.

    ``kwargs`` pass through to ``torch.distributed.init_process_group``;
    ``backend`` defaults to ``nccl`` on ``cuda`` (the default device) and
    ``gloo`` on the CPU. Without an ``init_method`` or ``store``, the
    rendezvous is torchrun's environment; where none of its variables is set
    (a process started on its own), the group is world size 1 on an
    in-process store. On ``cuda`` the process first selects its card,
    ``LOCAL_RANK`` (0 when unset), and binds the group to it
    (``device_id``). A group that is already initialized is kept; every
    other error propagates.
    """
    device = resolve_device(device)
    if dist.is_initialized():
        return
    kwargs.setdefault("backend", "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
        kwargs.setdefault("device_id", local)
    if ("init_method" not in kwargs and "store" not in kwargs
            and not any(v in os.environ for v in _LAUNCHER_VARIABLES)):
        kwargs.update(store=dist.HashStore(), rank=0, world_size=1)
    dist.init_process_group(**kwargs)


def make_mesh(data: Optional[int] = None, space: int = 1, device=None):
    """A ("data", "space") ``DeviceMesh`` over every rank of the process
    group, ``space`` the minor axis: ranks ``d * space .. d * space + space
    - 1`` hold one spatial ring.

    ``data`` defaults to all ranks over ``space``. The JAX package takes
    the first ``data * space`` devices and leaves the rest idle; a torch
    mesh must cover the whole world, so here ``data * space`` must equal the
    world size. Raises ValueError for a factorization that does not divide
    the world, needs more ranks than it has, or leaves ranks out.
    """
    from torch.distributed.device_mesh import init_device_mesh

    device = resolve_device(device)
    n = dist.get_world_size()
    if data is None:
        if n % space:
            raise ValueError(f"{n} ranks not divisible by space={space}")
        data = n // space
    need = data * space
    if need > n:
        raise ValueError(f"mesh {data}x{space} needs {need} ranks, have {n}")
    if need != n:
        raise ValueError(
            f"mesh {data}x{space} covers {need} of the {n} ranks; a torch "
            "device mesh must cover the whole world")
    return init_device_mesh(device.type, (data, space),
                            mesh_dim_names=(DATA_AXIS, SPACE_AXIS))


def axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in ``mesh`` (1 where the mesh has no such axis)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate on ``axis`` (0 where the mesh has none)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(axis) if axis in names else 0
