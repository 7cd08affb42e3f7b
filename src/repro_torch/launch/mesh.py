"""Production mesh builders (functions, not module constants: importing
this module touches no device and no process group).

The production meshes are ``DeviceMesh``es of 256 (one pod, 16 x 16,
``("data", "model")``) or 512 ranks (two pods, 2 x 16 x 16, ``("pod",
"data", "model")``) on a *fake* world of 512 ranks (`fake_world`): this
process is rank 0 and reads rank 0's local shards, and a collective
moves nothing. The dry-run (`repro_torch.launch.dryrun`) traces steps on
them under ``FakeTensorMode``; the 256-rank mesh is a sub-mesh of that
world.

`make_flat_mesh` is the CHL cluster view (paper §5: q independent
nodes): the port's `NodeMesh` of q logical nodes on one device.

The launchers `launch.train` and `launch.serve` run without a mesh on
one card: a 1 x 1 mesh shards nothing, so their steps are the
single-device ones.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.parallel.mesh import NodeMesh

#: the fake world's size: two pods of 16 x 16
WORLD = 512


@contextlib.contextmanager
def fake_world(world_size: int = WORLD):
    """A fake process group of ``world_size`` ranks in which this
    process is rank 0, destroyed on exit (a process holds one world)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device: DeviceLike):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() < n:
        raise RuntimeError(f"a {n}-rank mesh needs a world of at least "
                           f"{n} ranks (open one with fake_world())")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         dm_shape: Optional[Tuple[int, int]] = None,
                         device: DeviceLike = None):
    """16 x 16 single-pod (256 ranks) or 2 x 16 x 16 multi-pod (512
    ranks), on ``device``'s type (default: the card).

    Axes: ``pod`` (data-parallel across pods), ``data`` (batch / FSDP),
    ``model`` (TP / EP). ``dm_shape``: another (data, model)
    factorisation of the 256 ranks of a pod, e.g. (32, 8), whose 8-way
    TP axis divides head counts (56, 8) that 16 does not.
    """
    dm = tuple(dm_shape or (16, 16))
    if dm[0] * dm[1] != 256:
        raise ValueError(f"dm_shape {dm} is not a factorisation of 256")
    shape = (2,) + dm if multi_pod else dm
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device)


def make_flat_mesh(q: int, device: DeviceLike = None) -> NodeMesh:
    """The CHL cluster view: ``q`` logical nodes on one device (default:
    the card)."""
    return NodeMesh.logical(q, device)


def make_smoke_mesh(device: DeviceLike = None):
    """A ``(1, world)`` ``("data", "model")`` mesh over the ranks of the
    current process group."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("make_smoke_mesh needs a process group")
    return _mesh((1, dist.get_world_size()), ("data", "model"), device)
