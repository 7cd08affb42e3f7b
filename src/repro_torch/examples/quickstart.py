"""Quickstart: build a Canonical Hub Labeling index for a road-like
graph, validate it against Dijkstra, serve PPSD queries, and round-trip
the artifact through disk.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
"""

import os
import tempfile

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs import grid_road
from repro_torch.graphs.ranking import betweenness_ranking
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.sssp.oracle import dijkstra


def main(device: DeviceLike = None) -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the queried pairs and their answers."""
    dev = resolve_device(device)
    g = grid_road(20, 20, seed=7)
    rank = betweenness_ranking(g, samples=12)
    print(f"graph: n={g.n} m={g.m//2} (undirected road grid)")

    # one facade for every construction algorithm (plant / gll / lcc /
    # parapll / dgll / hybrid / plant-dist / directed / pll-ref)
    idx = build(g, rank, BuildPlan(algo="plant", batch=16), device=dev)
    print(f"CHL built: {idx.report.summary()}")
    print(f"max Ψ (explored per label) = {idx.report.max_psi:.1f}")

    rng = np.random.default_rng(0)
    u = rng.integers(0, g.n, 8).astype(np.int32)
    v = rng.integers(0, g.n, 8).astype(np.int32)
    d, hub = idx.query_with_hub(u, v)
    print("\nPPSD queries (hub-label intersection):")
    for ui, vi, di, hi in zip(u, v, d, hub):
        ref = dijkstra(g, int(ui))[vi]
        mark = "✓" if di == np.float32(ref) else "✗"
        print(f"  d({ui:3d},{vi:3d}) = {di:6.1f} via hub {hi:3d}  "
              f"dijkstra={ref:6.1f} {mark}")
        assert di == np.float32(ref)

    # the index is a first-class on-disk artifact
    with tempfile.TemporaryDirectory() as tmp:
        path = idx.save(os.path.join(tmp, "index"))
        idx2 = CHLIndex.load(path, rank=rank, device=dev)  # rank-hash checked
        srv = idx2.serve(mode="qlsn", batch_size=256)
        srv.warmup()                            # first launch outside p50/p99
        srv.submit(u, v)
        out = srv.flush()
        assert np.array_equal(out, d)
        print(f"\nsave → load → serve round trip OK "
              f"(warmup {srv.stats()['warmup_ms']:.0f} ms kept out of "
              f"p50/p99)")

        # label residency is pluggable: the same artifact re-homes as
        # hub-sharded partitions or memory-mapped spill segments
        sharded = CHLIndex.load(path, store="sharded", shards=2,
                                device=dev)
        assert np.array_equal(sharded.query(u, v), d)
        spilled = CHLIndex.load(path, store="spill", device=dev)
        assert np.array_equal(spilled.query(u, v), d)
        print(f"sharded ({sharded.store.num_shards} hub partitions) "
              f"and spill (memory-mapped) stores answer identically")

        # ...or quantized: u16 fixed-point is provably bit-exact on
        # this integer-weight graph, at a fraction of the bytes
        comp = CHLIndex.load(path, store="compressed", codec="u16",
                             quant_exact=True, device=dev)
        assert np.array_equal(comp.query(u, v), d)
        mr = comp.memory_report()
        print(f"compressed (codec=u16, exact) answers identically at "
              f"{mr['bytes_per_label']:.1f} B/label — "
              f"{mr['compression_ratio']:.1f}x smaller than dense f32")
    print("all queries exact — cover property holds")
    return {"u": u, "v": v, "dist": d, "hub": hub}


if __name__ == "__main__":
    main()
