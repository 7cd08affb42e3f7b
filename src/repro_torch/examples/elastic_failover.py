"""Fault-tolerance demo: node failure during distributed CHL
construction, recovered by re-PLaNTing the lost roots.

PLaNT trees depend on nothing but the graph and ranking, so recovery
after losing a node is *recomputation only*: no label state to
resurrect, no coordination. This script stops a node's heartbeat
mid-run, re-plants its outstanding roots on the survivors, and proves
the final labeling is still exactly the CHL.

    PYTHONPATH=src python -m repro_torch.examples.elastic_failover
"""

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core import validate
from repro_torch.core.dgll import assign_roots
from repro_torch.core.plant import plant_batch
from repro_torch.core.pll import pll_undirected
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import root_batches
from repro_torch.ft import HeartbeatMonitor, lost_roots
from repro_torch.graphs import device_adjacency, scale_free
from repro_torch.graphs.ranking import degree_ranking
from repro_torch.sssp import ell_layout


def main(device: DeviceLike = None) -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the recovered label table."""
    dev = resolve_device(device)
    g = scale_free(300, attach=2, seed=11)
    rank = degree_ranking(g)
    q = 8
    queues = assign_roots(rank, q)
    per = queues.shape[1]
    print(f"graph n={g.n}; q={q} nodes × {per} roots each")

    ell_src, ell_w, tail = device_adjacency(g, dev)
    batch = 16
    layout = ell_layout(ell_src, ell_w, batch=batch, tail=tail)
    rank_d = torch.as_tensor(rank.astype(np.int32), device=dev)
    table = lbl.empty(g.n, 128, dev)
    monitor = HeartbeatMonitor(q, patience=2)

    def plant_roots(roots: np.ndarray):
        nonlocal table
        for rb, vb in root_batches(roots.astype(np.int32), batch):
            safe = np.where(rb >= 0, rb, 0)
            safe_d = torch.as_tensor(safe, device=dev)
            tb = plant_batch(ell_src, ell_w, rank_d, safe_d,
                             torch.as_tensor(vb & (rb >= 0), device=dev),
                             layout=layout)
            table, ovf = lbl.insert_batch(table, safe_d, tb.emit, tb.dist)
            assert not bool(ovf)

    # --- normal progress: every node completes half its queue -------
    half = per // 2
    for node in range(q):
        plant_roots(queues[node, :half])
        monitor.report(node, superstep=half)

    # --- node 3 dies -------------------------------------------------
    dead = 3
    print(f"node {dead} stops heartbeating after superstep {half}…")
    for node in range(q):
        if node != dead:
            plant_roots(queues[node, half:])
            monitor.report(node, superstep=per)
    lost = monitor.lost(superstep=per)
    assert lost == [dead], lost
    missing = lost_roots(queues, lost, completed=half)
    print(f"detected lost={lost}; re-planting {len(missing)} roots "
          f"on survivors (zero-communication recovery)")
    plant_roots(missing)

    ref = pll_undirected(g, rank)
    validate.check_equal(lbl.to_numpy_sets(table), ref)
    print("recovered labeling == sequential PLL CHL — exact ✓")
    return {"table": table}


if __name__ == "__main__":
    main()
