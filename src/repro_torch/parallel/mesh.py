"""The node mesh: the port's counterpart of the reference's ``node``
mesh axis under ``shard_map``.

The reference runs a distributed build single-controller: one process
holds the hub-partitioned ``[q, n, L]`` table and runs each superstep
over a 1-D device mesh. The port does the same in one process with a
:class:`NodeMesh`, a list of q devices, one per CHL node, on which
per-node tensors live. A device may repeat: ``NodeMesh.logical(8,
"cuda")`` places eight nodes on one card (as the reference's tests
force eight host devices onto one CPU). Nodes exchange data only
through `repro_torch.parallel.collectives`.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, TypeVar

import torch

from repro_torch.device import DeviceLike, resolve_device

T = TypeVar("T")


class NodeMesh:
    """q CHL nodes, node ``i`` on ``devices[i]``; the one axis is
    named ``"node"``."""

    axis = "node"

    def __init__(self, devices: Sequence[DeviceLike]):
        if not devices:
            raise ValueError("a node mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @classmethod
    def logical(cls, q: int, device: DeviceLike = None) -> "NodeMesh":
        """``q`` nodes on one device (default: the card)."""
        return cls([resolve_device(device)] * int(q))

    @property
    def q(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Node 0's device: where host-facing results (the merged
        table, the query answers) land."""
        return self.devices[0]

    def replicate(self, make: Callable[[torch.device], T]) -> List[T]:
        """Per-node values built by ``make(device)`` once per distinct
        device: nodes that share a device share the value."""
        built: Dict[torch.device, T] = {}
        for d in self.devices:
            if d not in built:
                built[d] = make(d)
        return [built[d] for d in self.devices]

    def __repr__(self) -> str:
        return f"NodeMesh({[str(d) for d in self.devices]})"


def make_node_mesh(q: Optional[int] = None,
                   device: DeviceLike = None) -> NodeMesh:
    """One node per visible device of ``device``'s type (default: the
    card), at most ``q`` of them; the CPU is one device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    q = len(devs) if q is None else min(int(q), len(devs))
    return NodeMesh(devs[:max(1, q)])
