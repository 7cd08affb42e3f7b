"""Dynamic repair: mutate a graph under a live CHL index, re-plant only
the affected trees, and keep serving, with the repaired labels
bit-identical to a from-scratch rebuild on the mutated graph.

    PYTHONPATH=src python -m repro_torch.examples.dynamic_repair
"""

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dynamic import (EdgeDelete, EdgeInsert, EdgeReweight,
                                 MutationBatch)
from repro_torch.graphs import grid_road
from repro_torch.graphs.ranking import betweenness_ranking
from repro_torch.index import BuildPlan, build
from repro_torch.sssp.oracle import dijkstra


def main(device: DeviceLike = None) -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the repaired index, the served pairs and their answers."""
    dev = resolve_device(device)
    g = grid_road(16, 16, seed=7)
    rank = betweenness_ranking(g, samples=12)
    idx = build(g, rank, BuildPlan(algo="plant", batch=16), device=dev)
    print(f"built: {idx.report.summary()}")

    # a live service handed out BEFORE the mutation: apply() will
    # refresh its answer fn and bump its cache epoch automatically
    svc = idx.serve(mode="qlsn", batch_size=256, cache=1024)
    svc.warmup()

    # one atomic batch: close a road, open a link, congest another.
    # These touch *slack* (heavy) edges, so their invalidation cones
    # stay local: a cheap edge on this integer-weighted grid is tied
    # into most trees' shortest paths and would invalidate widely.
    batch = MutationBatch([
        EdgeDelete(4, 5),                  # road closed (w was 13)
        EdgeInsert(0, 2, 14.0),            # new link, not a shortcut
        EdgeReweight(9, 25, 20.0),         # congestion reweight
    ])
    rep = idx.apply(batch, graph=g)        # repairs in place
    print(f"repaired: {rep.summary()}")
    print(f"  trees re-planted: {rep.affected}/{g.n} "
          f"({100 * rep.affected / g.n:.0f}% — the rest proved "
          f"untouched by the frontier test)")

    # the already-open service now answers for the mutated graph
    g_new = batch.apply(g)
    rng = np.random.default_rng(0)
    u = rng.integers(0, g.n, 8).astype(np.int32)
    v = rng.integers(0, g.n, 8).astype(np.int32)
    svc.submit(u, v)
    out = svc.flush()
    for ui, vi, di in zip(u, v, out):
        ref = dijkstra(g_new, int(ui))[vi]
        mark = "✓" if di == np.float32(ref) else "✗"
        print(f"  d({ui:3d},{vi:3d}) = {di:6.1f}  "
              f"dijkstra(mutated)={ref:6.1f} {mark}")
        assert di == np.float32(ref)
    print(f"service stats: invalidations="
          f"{svc.stats_.invalidations}")

    # bit-identity: the repaired arrays ARE the from-scratch ones
    ref_idx = build(g_new, rank, BuildPlan(algo="plant", batch=16,
                                           cap=rep.cap), device=dev)
    for (_, a), (_, b) in zip(idx.store.shard_arrays(),
                              ref_idx.store.shard_arrays()):
        for key in ("hubs", "dist", "count"):
            assert np.array_equal(np.asarray(a[key]),
                                  np.asarray(b[key]))
    print("repair == rebuild, bit for bit ✓")
    return {"index": idx, "u": u, "v": v, "dist": out}


if __name__ == "__main__":
    main()
