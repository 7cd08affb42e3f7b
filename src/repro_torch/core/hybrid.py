"""Hybrid PLaNT + DGLL (§5.2.1) — the paper's flagship algorithm.

The superstep driver is the engine's: `repro_torch.engine.dist.
DistributedPolicy` driven by `repro_torch.engine.run`. What remains
here is the ``run_distributed`` surface, a thin wrapper that assembles
the policy and translates the engine's typed records into the stats
dict of the ``*_chl`` API:

- phase 0 (η > 0): the top-η trees are PLaNTed and their labels form
  the replicated **Common Label Table** (§5.3), recomputed per device
  instead of broadcast (PLaNT trees depend on nothing);
- phase 1: PLaNT supersteps (HC-pruned) while ``Ψ <= Ψ_th``;
- phase 2: once ``Ψ > Ψ_th``, DGLL supersteps — heavy pruning,
  broadcast and distributed cleaning;
- superstep sizes grow geometrically by ``β`` (§5.1).

``psi_threshold=inf`` gives pure PLaNT; ``psi_threshold=0`` pure DGLL.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable

__all__ = ["auto_psi_threshold", "hybrid_chl", "plant_distributed_chl",
           "run_distributed"]


def auto_psi_threshold(q: int, gamma: float = 12.0) -> float:
    """Ψ_th as a function of cluster size (`repro_torch.engine.dist.
    auto_psi_threshold`, imported lazily: ``core`` stays importable
    below the engine)."""
    from repro_torch.engine.dist import auto_psi_threshold as f
    return f(q, gamma)


def run_distributed(g, rank: np.ndarray, *, mesh=None, batch: int = 4,
                    beta: float = 8.0, first_superstep: int = 1,
                    cap: Optional[int] = None, eta: int = 0,
                    hc_cap: int = 64,
                    psi_threshold: Optional[float] = 100.0,
                    compact: int = 0, ckpt=None, resume: bool = False,
                    verbose: bool = False, algo_name: str = "hybrid",
                    monitor=None, silent_after=None
                    ) -> Tuple[LabelTable, dict]:
    """Distributed CHL construction on ``mesh`` (a `NodeMesh`; default:
    one node per card). Returns (merged table on node 0's device,
    stats).

    ``psi_threshold=None`` picks Ψ_th from the mesh size. ``ckpt`` (a
    `CheckpointManager`) commits the partitions and the superstep
    cursor after every superstep; ``resume=True`` continues from the
    last committed one (a checkpoint under a *smaller* ``cap`` is
    padded). ``monitor`` (a `HeartbeatMonitor`) turns on node-loss
    detection: a node silent past the monitor's patience is declared
    dead and its unfinished root queue is re-PLaNTed on the survivors
    (§5.2); ``silent_after`` (node -> last completed superstep) is the
    fault-simulation hook.
    """
    from repro_torch.core.dgll import merge_partitions
    from repro_torch.engine.dist import DistributedPolicy
    from repro_torch.engine.runner import run
    from repro_torch.engine.sink import MeshTableSink
    from repro_torch.parallel.mesh import make_node_mesh
    mesh = mesh or make_node_mesh()
    n = g.n
    cap = cap or lbl.default_cap(n)
    policy = DistributedPolicy(
        g, rank, mesh=mesh, batch=batch, beta=beta,
        first_superstep=first_superstep, cap=cap, eta=eta, hc_cap=hc_cap,
        psi_threshold=psi_threshold, compact=compact, mode_name=algo_name,
        verbose=verbose, monitor=monitor, silent_after=silent_after)
    sink = MeshTableSink(mesh, n, cap)
    res = run(policy, sink, ckpt=ckpt, resume=resume, verbose=verbose)

    merged = merge_partitions(sink.tables)
    stats = {"mode": [r.mode for r in res.records],
             "labels": [r.labels for r in res.records],
             "explored": [r.explored for r in res.records],
             "psi": [r.psi for r in res.records],
             "comm_label_slots": res.counters["comm_label_slots"],
             "replanted_trees": res.counters.get("replanted_trees", 0),
             "replanted_labels": res.counters.get("replanted_labels", 0),
             "dead_nodes": list(policy.dead_nodes),
             "q": res.extras["q"],
             "psi_threshold": res.extras["psi_threshold"],
             "partitioned": res.extras["partitioned"],
             "hc": res.extras["hc"]}
    return merged, stats


def hybrid_chl(g, rank: np.ndarray, *, mesh=None, batch: int = 4,
               beta: float = 8.0, eta: int = 16,
               psi_threshold: float = 100.0, cap: Optional[int] = None,
               hc_cap: int = 64, compact: int = 0, **kw
               ) -> Tuple[LabelTable, dict]:
    """The paper's Hybrid algorithm (PLaNT -> DGLL, Common Label
    Table)."""
    return run_distributed(g, rank, mesh=mesh, batch=batch, beta=beta,
                           cap=cap, eta=eta, hc_cap=hc_cap,
                           psi_threshold=psi_threshold, compact=compact,
                           algo_name="hybrid", **kw)


def plant_distributed_chl(g, rank: np.ndarray, *, mesh=None,
                          batch: int = 4, beta: float = 8.0,
                          cap: Optional[int] = None, **kw
                          ) -> Tuple[LabelTable, dict]:
    """Pure distributed PLaNT (§5.2): zero label communication."""
    return run_distributed(g, rank, mesh=mesh, batch=batch, beta=beta,
                           cap=cap, eta=0, psi_threshold=float("inf"),
                           algo_name="plant-dist", **kw)
