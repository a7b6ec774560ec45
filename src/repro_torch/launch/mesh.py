"""Production and local meshes (``repro.launch.mesh``).

``make_production_mesh`` builds the reference's 16x16 ("data", "model") or
2x16x16 ("pod", "data", "model") mesh, axis names and shapes unchanged so
every spec compares one to one with the reference. It stands for 256 / 512
H100s in 8-GPU nodes, and runs on a fake process group of that many ranks
in this one process (``torch.testing._internal.distributed.fake_pg``): the
dry-run's stand-in for the reference's 512 placeholder host devices. The
fake group is global state; only the dry-run paths (``launch.dryrun``,
``launch.train --mesh prod*``) build it.

``make_local_mesh`` is a mesh over the devices this process has. On one
device (the card, or the CPU alone) it is an ``AbstractMesh`` of size 1,
which needs no process group, so ``constrain`` and the placements are
no-ops there, as in the reference; that device is the caller's, the card
by default, and the mesh raises where no card is present and the CPU was
not asked for. A ``DeviceMesh`` is built only when
torch.distributed is already initialised with more than one rank.
"""
from __future__ import annotations

import math

from repro_torch.distributed.sharding import AbstractMesh


def init_fake_process_group(world_size: int) -> None:
    """A fake process group of ``world_size`` ranks in this process (rank
    0): collectives return at once and move nothing. Raises if a group of
    another size is already initialised."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialised; the mesh needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 (one pod, 256 GPUs) or 2x16x16 (two pods, 512 GPUs) on a fake
    process group of that size: a ``DeviceMesh`` of device type "cpu"
    whose tensors the dry-run keeps on ``meta``."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    init_fake_process_group(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def make_local_mesh(model_parallel: int = 1, device="cuda"):
    """Mesh over the devices this process has: ("data", "model") of
    (n // mp, mp), mp = ``model_parallel`` where it divides n, else 1. n is
    the world size of an initialised torch.distributed group of more than
    one rank (a ``DeviceMesh`` on the backend's device: gloo's the CPU,
    nccl's the card); otherwise one device, ``device`` (an ``AbstractMesh``
    of size 1): the card unless the caller asks for the CPU, and an error
    where the card is asked for but absent."""
    import torch.distributed as dist
    n = dist.get_world_size() if (dist.is_available()
                                  and dist.is_initialized()) else 1
    mp = model_parallel if n % model_parallel == 0 else 1
    if n == 1:
        from repro_torch.models.model import require_device
        return AbstractMesh((1, 1), ("data", "model"),
                            require_device(device).type)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n // mp, mp),
                            mesh_dim_names=("data", "model"))
