#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which either passes or ends the run with a non-zero exit:

1. build every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, all started together);
2. kernel parity: each kernel against its plain PyTorch version with
   ``torch.equal`` at ragged shapes (ell_relax: deg 1..40, B in
   {1, 4, 32}, retired trees, inf padding; label_query: L in
   {8, 288, 700} with ties and disjoint rows);
3. exactness: grid_road(64, 64) (n = 4096), a full PLaNT build on the
   card, 4096 ``query_with_hub`` answers equal to scipy's Dijkstra, and
   save -> load -> serve(qlsn) -> flush equal to ``query``;
4. road scale (the main path at full width): the chl-road
   configuration, grid_road(4096, 4096) (n = 16,777,216, ELL width 8),
   one PLaNT superstep of one cluster node — 8 unpruned trees in
   batches of 4, label cap 8 — then 65,536 qlsn queries through the
   serving tier; every label of one root is checked against Dijkstra
   and the served answers against the plain query. Launch counts are
   reset just before this phase and read just after it;
5. timing of each kernel at the main path's shapes (CUDA events)
   beside its plain version and its memory/compute bound.

The last lines are the card (``nvidia-smi`` name and power limit), one
JSON object with the per-kernel record, and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the f32 rate
#: outside the tensor cores, used as the rate of the kernels' integer
#: and f32 compare/add work
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

ROAD_ROWS = ROAD_COLS = 4096      # repro/configs/chl_road.py: n = 16,777,216
ROAD_TREES, ROAD_BATCH, ROAD_CAP = 8, 4, 8


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi unavailable (rc={out.returncode})"


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """Largest |a - b| (inf - inf counts as 0; a finite/inf mismatch
    as inf)."""
    import torch
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max()) if d.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ------------------------------------------------------------ operands

def sweep_operands(rng, B, n, deg, device, dead_frac=0.25):
    """Random ell_relax operands: ragged shapes, integral weights with
    +inf padding, rank ties in distance, unreachable vertices, retired
    trees whose planes are left dense."""
    import numpy as np
    import torch
    dist = np.where(rng.random((B, n)) < 0.6,
                    rng.integers(0, 9, (B, n)), np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 99, (B, n)),
                     -1).astype(np.int32)
    frontier = rng.random((B, n)) < 0.7
    prop = np.where(frontier, dist, np.inf).astype(np.float32)
    alive = rng.random(B) >= dead_frac
    ell_src = rng.integers(0, n, (n, deg)).astype(np.int32)
    ell_w = np.where(rng.random((n, deg)) < 0.6,
                     rng.integers(1, 9, (n, deg)),
                     np.inf).astype(np.float32)
    rank = rng.permutation(n).astype(np.int32)
    return [torch.as_tensor(x, device=device)
            for x in (dist, mrank, prop, alive, ell_src, ell_w, rank)]


def label_operands(rng, Q, L, device):
    """Random label rows: few distinct hubs (many ties), -1 padding,
    and every 7th query disjoint."""
    import numpy as np
    import torch
    hubs_u = rng.integers(-1, 40, (Q, L)).astype(np.int32)
    hubs_v = rng.integers(-1, 40, (Q, L)).astype(np.int32)
    hubs_v[::7] = np.where(hubs_v[::7] >= 0, hubs_v[::7] + 1000, -1)
    dist_u = np.where(hubs_u >= 0, rng.integers(0, 6, (Q, L)),
                      np.inf).astype(np.float32)
    dist_v = np.where(hubs_v >= 0, rng.integers(0, 6, (Q, L)),
                      np.inf).astype(np.float32)
    return [torch.as_tensor(x, device=device)
            for x in (hubs_u, dist_u, hubs_v, dist_v)]


def ell_relax_bound_ms(B, n, deg, live):
    """(ms, "bytes" | "operations"): the least time for one sweep.
    Each input is read once and each output written once; retired trees
    read only dist/mrank. The fold's add/compare/max per live in-edge
    runs at the f32 rate."""
    ell = (8 * deg + 4) * n if live else 0      # ELL rows + rank row
    bytes_ = ell + B + 8 * B * n + 4 * live * n + 8 * B * n
    ops = 3 * live * n * deg
    tb, to = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def label_query_bound_ms(Q, L):
    """(ms, "bytes" | "operations") for four [Q, L] operand reads and
    two [Q] outputs, and Q * L * L hub compares (plus an add on a
    match) at the f32 rate."""
    bytes_ = 16 * Q * L + 8 * Q
    ops = Q * L * L
    tb, to = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


# -------------------------------------------------------------- phases

def phase_parity(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.ell_relax import ell_relax, ell_sweep_plain
    from repro_torch.kernels.label_query import label_query, label_query_ref
    rng = np.random.default_rng(11)
    for B in (1, 4, 32):
        for n, deg in ((1, 1), (333, 3), (1000, 8), (4097, 17), (777, 40)):
            ops = sweep_operands(rng, B, n, deg, dev)
            kd, km = ell_relax(*ops)
            pd, pm = ell_sweep_plain(*ops)
            torch.cuda.synchronize()
            require(torch.equal(kd, pd) and torch.equal(km, pm),
                    f"ell_relax != plain at B={B} n={n} deg={deg}")
    log("parity ell_relax: torch.equal at B in {1,4,32} x (n, deg) in "
        "{(1,1),(333,3),(1000,8),(4097,17),(777,40)} — retired trees, "
        "inf padding, ties")
    for L in (8, 288, 700):
        for Q in (1, 45, 1000):
            ops = label_operands(rng, Q, L, dev)
            kd, kh = label_query(*ops)
            pd, ph = label_query_ref(*ops)
            torch.cuda.synchronize()
            require(torch.equal(kd, pd) and torch.equal(kh, ph),
                    f"label_query != plain at Q={Q} L={L}")
            require(bool(torch.isinf(kd[::7]).all()),
                    "disjoint rows must answer +inf")
    log("parity label_query: torch.equal (dist, hub) at L in {8,288,700} "
        "x Q in {1,45,1000} — ties, disjoint rows")


def phase_exactness(dev, kernels) -> None:
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.graphs import betweenness_ranking, grid_road
    from repro_torch.index import BuildPlan, CHLIndex, build
    g = grid_road(64, 64, seed=7)
    rank = betweenness_ranking(g, samples=12)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    idx = build(g, rank, BuildPlan(algo="plant", batch=16), device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(3)
    u = rng.integers(0, g.n, 4096)
    v = rng.integers(0, g.n, 4096)
    d, hub = idx.query_with_hub(u, v)
    A = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                      shape=(g.n, g.n))
    D = dijkstra(A, indices=np.unique(u))
    row = {x: i for i, x in enumerate(np.unique(u).tolist())}
    want = D[[row[x] for x in u.tolist()], v].astype(np.float32)
    require(np.array_equal(d, want), "exactness: query != Dijkstra")
    require(bool((hub >= 0).all()), "exactness: every pair has a hub")
    scratch = ROOT / "build"                # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = idx.save(os.path.join(tmp, "index"))
        idx2 = CHLIndex.load(path, rank=rank, device=dev)
        srv = idx2.serve(mode="qlsn", batch_size=1024)
        srv.submit(u, v)
        out = srv.flush()
    require(np.array_equal(out, d), "exactness: served != query")
    counts = {k.name: k.launches for k in kernels}
    require(all(c > 0 for c in counts.values()),
            f"exactness: a kernel was not launched: {counts}")
    sweeps = [r.sweeps for r in idx.report.supersteps]
    log(f"exactness n={g.n}: build {wall:.3f} s, "
        f"{len(sweeps)} supersteps, {sum(sweeps)} sweeps, "
        f"{idx.total_labels} labels (ALS {idx.als:.2f}, cap "
        f"{idx.report.cap}); 4096 query_with_hub == scipy Dijkstra; "
        f"save->load->serve(qlsn)->flush == query; launches {counts}")


def phase_road(dev, kernels) -> dict:
    """The main path at full width; returns what the timing phase and
    the record need."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core import labels as lbl
    from repro_torch.engine import rank_order, run_build
    from repro_torch.graphs import degree_ranking, grid_road
    from repro_torch.index import BuildPlan, BuildReport, CHLIndex
    from repro_torch.index.store import DenseStore

    t0 = time.perf_counter()
    g = grid_road(ROAD_ROWS, ROAD_COLS)
    rank = degree_ranking(g)
    roots = rank_order(rank)[:ROAD_TREES]
    log(f"road graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s")

    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_build(g, rank, algo="plant", batch=ROAD_BATCH, cap=ROAD_CAP,
                    roots_order=roots, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = res.sink.table()
    total = lbl.total_labels(table)
    plan = BuildPlan(algo="plant", batch=ROAD_BATCH, cap=ROAD_CAP)
    report = BuildReport(algo="plant", wall_s=wall, total_labels=total,
                         als=total / g.n, cap=ROAD_CAP,
                         supersteps=list(res.records))
    idx = CHLIndex(DenseStore(table), plan=plan, report=report, rank=rank)
    rng = np.random.default_rng(5)
    u = rng.integers(0, g.n, 65536)
    v = rng.integers(0, g.n, 65536)
    srv = idx.serve(mode="qlsn", batch_size=65536)
    t1 = time.perf_counter()
    srv.submit(u, v)
    served = srv.flush()
    serve_wall = time.perf_counter() - t1
    launches = {k.name: k.launches for k in kernels}
    require(all(c > 0 for c in launches.values()),
            f"road: a kernel of the main path was not launched: {launches}")

    sweeps = sum(r.sweeps for r in res.records)
    bound, by = ell_relax_bound_ms(ROAD_BATCH, g.n, g.max_deg_in,
                                   ROAD_BATCH)
    log(f"road build: {len(res.records)} supersteps x {ROAD_BATCH} trees, "
        f"{sweeps} sweeps, {total} labels, wall {wall:.2f} s, "
        f"{wall / max(1, sweeps) * 1e3:.3f} ms per sweep end to end "
        f"(kernel bound {bound:.3f} ms per sweep, {by}), ell_relax "
        f"launches {launches['ell_relax']}")
    log(f"road serve: 65536 qlsn queries in one launch, host wall "
        f"{serve_wall:.3f} s, label_query launches "
        f"{launches['label_query']}")

    # f32 path sums are exact only below 2^24
    finite = table.dist[torch.isfinite(table.dist)]
    dmax = float(finite.max())
    require(dmax < 2 ** 24, f"road: largest label distance {dmax} >= 2^24")
    # every label of the top root against Dijkstra
    r = int(roots[0])
    A = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                      shape=(g.n, g.n))
    t1 = time.perf_counter()
    D = dijkstra(A, indices=r)
    hubs = table.hubs.cpu().numpy()
    dist = table.dist.cpu().numpy()
    vs, ks = np.nonzero(hubs == r)
    require(len(vs) == g.n, f"road: top root labels {len(vs)} of {g.n}")
    require(np.array_equal(dist[vs, ks], D[vs].astype(np.float32)),
            "road: root labels != Dijkstra")
    log(f"road check: largest label distance {dmax:.0f} < 2^24; all "
        f"{len(vs)} labels of root {r} == scipy Dijkstra "
        f"({time.perf_counter() - t1:.1f} s)")
    plain, _ = lbl.query_pairs(table, torch.as_tensor(u, device=dev),
                               torch.as_tensor(v, device=dev))
    require(np.array_equal(served, plain.cpu().numpy()),
            "road: served != plain query")
    require(bool(np.isfinite(served).all()), "road: every pair shares the "
            "top root, so every answer is finite")
    log("road serve: 65536 served answers == plain query_pairs")
    return {"g": g, "rank": rank, "roots": roots, "table": table,
            "launches": launches, "u": u, "v": v}


def phase_timing(dev, road) -> list:
    """Each kernel at the main path's shapes vs its plain version."""
    import torch
    from repro_torch.kernels.ell_relax import ell_relax, ell_sweep_plain
    from repro_torch.kernels.label_query import label_query, label_query_ref
    from repro_torch.graphs import device_arrays
    from repro_torch.sssp import batched_sssp_maxrank
    g, rank, roots = road["g"], road["rank"], road["roots"]
    a = device_arrays(g, rank, dev)
    roots_d = torch.as_tensor(roots[:ROAD_BATCH], device=dev).long()
    # a mid-build state of the first superstep's trees
    st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots_d,
                              max_sweeps=256)
    B, n = st.dist.shape
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    ops = (st.dist, st.mrank, st.dist, alive, a.ell_src, a.ell_w, a.rank)
    kd, km = ell_relax(*ops)
    pd, pm = ell_sweep_plain(*ops)
    torch.cuda.synchronize()
    require(torch.equal(kd, pd) and torch.equal(km, pm),
            "ell_relax != plain at the road shape")
    err = max(max_abs_err(kd, pd), max_abs_err(km, pm))
    del kd, km, pd, pm
    ell_ms = time_ms(lambda: ell_relax(*ops), reps=20)
    ell_plain_ms = time_ms(lambda: ell_sweep_plain(*ops), reps=3, warmup=1)
    bound, by = ell_relax_bound_ms(B, n, a.ell_src.shape[1], B)
    log(f"time ell_relax B={B} n={n} deg={a.ell_src.shape[1]}: kernel "
        f"{ell_ms:.4f} ms, plain {ell_plain_ms:.4f} ms, bound {bound:.4f} "
        f"ms ({by}); {bound / ell_ms * 100:.1f}% of the bound")
    del ops, st
    torch.cuda.empty_cache()

    table = road["table"]
    u = torch.as_tensor(road["u"], device=dev)
    v = torch.as_tensor(road["v"], device=dev)
    lops = (table.hubs[u], table.dist[u], table.hubs[v], table.dist[v])
    kd, kh = label_query(*lops)
    pd, ph = label_query_ref(*lops)
    torch.cuda.synchronize()
    require(torch.equal(kd, pd) and torch.equal(kh, ph),
            "label_query != plain at the road serving shape")
    lq_err = max_abs_err(kd, pd)
    Q, L = lops[0].shape
    lq_ms = time_ms(lambda: label_query(*lops), reps=100)
    lq_plain_ms = time_ms(lambda: label_query_ref(*lops), reps=20)
    lq_bound, lq_by = label_query_bound_ms(Q, L)
    log(f"time label_query Q={Q} L={L}: kernel {lq_ms:.4f} ms, plain "
        f"{lq_plain_ms:.4f} ms, bound {lq_bound:.4f} ms ({lq_by}); "
        f"{lq_bound / lq_ms * 100:.1f}% of the bound")
    return [
        {"name": "ell_relax", "route": "cuda",
         "source": "src/repro_torch/kernels/ell_relax/csrc/ell_relax.cu",
         "replaces": "src/repro/kernels/ell_relax/ell_relax.py:123",
         "launches": road["launches"]["ell_relax"], "max_abs_err": err,
         "ms": ell_ms, "plain_ms": ell_plain_ms, "bound_ms": bound,
         "bound_by": by, "library_ms": None},
        {"name": "label_query", "route": "cuda",
         "source": "src/repro_torch/kernels/label_query/csrc/"
                   "label_query.cu",
         "replaces": "src/repro/kernels/label_query/label_query.py:32",
         "launches": road["launches"]["label_query"],
         "max_abs_err": lq_err, "ms": lq_ms, "plain_ms": lq_plain_ms,
         "bound_ms": lq_bound, "bound_by": lq_by, "library_ms": None},
    ]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from repro_torch.kernels import all_kernels, build_all
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card})")

    t0 = time.perf_counter()
    kernels = build_all(all_kernels())
    log(f"kernel build (nvcc, sm_90a, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    phase_parity(dev)
    phase_exactness(dev, kernels)
    road = phase_road(dev, kernels)
    records = phase_timing(dev, road)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
