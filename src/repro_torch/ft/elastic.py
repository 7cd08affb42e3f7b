"""Node loss and re-meshing for the distributed builds.

A distributed build survives (a) node loss, by restarting from the
latest atomic checkpoint on a *smaller* mesh, and (b) node gain, by
rescaling up. `reshard_state` is the mechanism behind both: checkpoints
hold host arrays, so restoring onto another mesh is placing each
node's slice on that mesh's devices. For CHL, recovery is cheaper
still: PLaNT supersteps carry no state beyond the label partitions, so
a lost node's unfinished root queue is simply re-PLaNTed on the
survivors (the paper's §5.2 independence property as a recovery
mechanism; `repro_torch.engine.dist.DistributedPolicy` drives it).

Straggler mitigation: the round-robin-by-rank root assignment
(`repro_torch.core.dgll.assign_roots`) balances tree-size skew across
nodes (paper Fig. 2).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

import numpy as np
import torch

if TYPE_CHECKING:   # import cycle: checkpoint.manager uses ft.inject
    from repro_torch.checkpoint.manager import CheckpointManager


def _place(x, mesh):
    """One node-axis leaf onto ``mesh``: a ``[q, ...]`` array becomes
    a list of per-node tensors (row ``i`` on node ``i``'s device); a
    list of per-node tensors is re-placed node by node."""
    if isinstance(x, (list, tuple)):
        if len(x) != mesh.q:
            raise ValueError(f"{len(x)} per-node values for a mesh of "
                             f"{mesh.q} nodes")
        return [torch.as_tensor(np.asarray(t.cpu() if isinstance(
            t, torch.Tensor) else t)).to(d) for t, d in zip(x, mesh.devices)]
    arr = torch.as_tensor(np.asarray(x.cpu() if isinstance(
        x, torch.Tensor) else x))
    if arr.shape[0] != mesh.q:
        raise ValueError(f"a node axis of {arr.shape[0]} for a mesh of "
                         f"{mesh.q} nodes")
    return [arr[i].to(d).contiguous() for i, d in enumerate(mesh.devices)]


def reshard_state(state: Any, mesh) -> Any:
    """Re-place a state (a dict of node-axis leaves, nested freely) onto
    ``mesh``: each ``[q, ...]`` array or per-node list becomes per-node
    tensors on the mesh's devices."""
    if isinstance(state, dict):
        return {k: reshard_state(v, mesh) for k, v in state.items()}
    return _place(state, mesh)


def restore_elastic(mgr: "CheckpointManager", template: Any, mesh,
                    step: Optional[int] = None) -> Tuple[Any, int, Dict]:
    """Restore a checkpoint (host arrays) onto a possibly different
    mesh: ``(state with per-node tensors, step, data_state)``."""
    state, step, data_state = mgr.restore(template, step=step)
    return reshard_state(state, mesh), step, data_state


def lost_roots(queues: np.ndarray, lost_nodes: list[int],
               completed: int) -> np.ndarray:
    """CHL recovery: the not-yet-completed roots of failed nodes.

    ``queues``: the `assign_roots` matrix; ``completed``: the number of
    per-node queue positions already committed. The survivors re-PLaNT
    these roots (order does not matter: PLaNT trees are independent)."""
    rest = queues[lost_nodes, completed:]
    return rest[rest >= 0]


class HeartbeatMonitor:
    """Host-side failure detector used by the superstep loop: nodes
    report per-superstep progress; nodes silent for more than
    ``patience`` supersteps are declared lost."""

    def __init__(self, q: int, patience: int = 3):
        self.last_seen = np.zeros(q, dtype=np.int64)
        self.patience = patience

    def report(self, node: int, superstep: int) -> None:
        self.last_seen[node] = superstep

    def lost(self, superstep: int) -> list[int]:
        return [int(i) for i in
                np.nonzero(superstep - self.last_seen > self.patience)[0]]
