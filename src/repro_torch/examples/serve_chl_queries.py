"""End-to-end driver of the paper's system: distributed CHL
construction (Hybrid PLaNT -> DGLL) + PPSD query serving through the
continuous-batching service tier (`repro_torch.serve.QueryService`) in
all three modes (QLSN / QFDL / QDOL) on 8 logical nodes of one device
(`NodeMesh.logical(8, device)`), all through the `repro_torch.index`
artifact API, plus a production-shaped service demo (hot-pair cache,
per-query tickets, deadline pump, admission control, service stats).

    PYTHONPATH=src python -m repro_torch.examples.serve_chl_queries
"""

import time

import numpy as np

from repro_torch.device import DeviceLike, resolve_device


def main(device: DeviceLike = None) -> dict:
    """Runs on ``device`` (default: the card; raises without CUDA);
    returns the index and the three modes' answers."""
    from repro_torch.graphs import scale_free
    from repro_torch.graphs.ranking import degree_ranking
    from repro_torch.index import BuildPlan, build
    from repro_torch.parallel import NodeMesh

    dev = resolve_device(device)
    g = scale_free(600, attach=2, seed=3)
    rank = degree_ranking(g)
    mesh = NodeMesh.logical(8, dev)
    print(f"cluster: q={mesh.q} nodes; graph n={g.n}")

    plan = BuildPlan(algo="hybrid", batch=4, eta=16, psi_th=100.0)
    idx = build(g, rank, plan, mesh=mesh)
    modes = [s.mode for s in idx.report.supersteps]
    print(f"hybrid CHL in {idx.report.wall_s:.1f}s — supersteps: {modes}")
    print(f"ALS = {idx.als:.1f}; label slots broadcast = "
          f"{idx.report.comm_label_slots:,}")
    print(idx.memory_report())

    rng = np.random.default_rng(1)
    Q = 2048
    u = rng.integers(0, g.n, Q).astype(np.int32)
    v = rng.integers(0, g.n, Q).astype(np.int32)

    ref = None
    answers = {}
    for mode in ("qlsn", "qfdl", "qdol"):
        srv = idx.serve(mode=mode, mesh=mesh, batch_size=Q)
        srv.warmup()
        srv.submit(u, v)
        out = srv.flush()
        if ref is None:
            ref = out
        assert np.array_equal(ref, out), mode
        answers[mode] = out
        t0 = time.time()
        for _ in range(3):
            srv.submit(u, v)
            srv.flush()
        dt = (time.time() - t0) / 3
        print(f"{mode.upper()}: {Q/dt:10,.0f} queries/s "
              f"({1e6*dt/Q:.2f} µs/query)")
    print("all three modes agree — serving path verified")

    # ---- the production shape: cached, deadline-batched, bounded ----
    from repro_torch.serve import zipf_pairs
    svc = idx.serve(mode="qlsn", batch_size=256, deadline_ms=2.0,
                    cache=4096, max_queue=8192)
    svc.warmup(buckets=True)
    zu, zv = zipf_pairs(g.n, 4096, rng)      # skewed: hot pairs repeat
    tickets = []
    for a, b in zip(zu.tolist(), zv.tolist()):
        tk = svc.try_submit(a, b)            # None would mean rejected
        assert tk is not None
        tickets.append(tk)
        svc.pump()                           # fire deadline-due batches
    svc.drain()
    assert all(t.done for t in tickets)
    got = np.asarray([t.value for t in tickets], np.float32)
    assert np.array_equal(got, np.asarray(idx.query(zu, zv))), "cache"
    st = svc.stats()
    print(f"service: {st['queries']} answered in {st['batches']} "
          f"launches, occupancy {st['batch_occupancy']:.2f}, cache hit "
          f"rate {st['cache_hit_rate']:.2f}, capacity "
          f"{st['capacity_qps']:,.0f} q/s")
    print("cached service bit-identical to direct query — "
          "serving tier verified")
    return {"index": idx, "u": u, "v": v, "answers": answers}


if __name__ == "__main__":
    main()
