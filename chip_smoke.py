#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which either passes or ends the run with a non-zero exit:

1. build every hand-written kernel from the sources in this checkout
   (one ``nvcc`` per source, all started together);
2. kernel parity: each kernel against its plain PyTorch version with
   ``torch.equal`` at ragged shapes (ell_relax: deg 1..40, B in
   {1, 4, 32}, retired trees, inf padding; ell_relax_windowed: the same
   at 2, 3, 4 and 7 forced source windows against the bucketed plain
   sweep; label_query's operand form: L in {8, 288, 700} with ties and
   disjoint rows; its table form through ``query_table``: L in
   {1, 3, 8, 9, 32, 33, 288, 700} x Q in {1, 45, 1000, 65,537} with
   counts 0..L, repeated hubs, ties, disjoint rows, u == v and negative
   ids; minplus: ragged (B, K, N), all-unreachable and tie cases); the
   windowed sweep also at B in {3, 5, 33}, with a hub row longer than
   a tile's edge buffer, an empty window, one tree alive and none;
3. exactness: grid_road(64, 64) (n = 4096), a full PLaNT build on the
   card, whose planes fit one source window (the dense ell_relax),
   4096 ``query_with_hub`` answers equal to scipy's Dijkstra, and
   save -> load -> serve(qlsn) -> flush equal to ``query``; then a
   profiler window over 64 of its sweeps (as in phases 5 and 6) and
   the dense ell_relax timed on two mid-build states that are its
   largest: grid_road(896, 896) (n = 802,816) and
   random_connected(786,432, 786,432 extra edges) at the road batch of
   4, whose two source planes just fit half the L2, each equal to the
   plain sweep; on the first, ``affected_hubs`` for a seeded batch of
   4 mutations (the frontier's endpoint sweeps; no re-plant at this n);
3b. shared-memory exactness: on phase 3's graph and ranking, a full
   ``build`` of each of pll-ref (the host PLL oracle replayed through
   the engine), gll (alpha = 4), lcc and parapll at batch 16: gll, lcc
   and pll-ref each equal phase 3's PLaNT table (``torch.equal`` on
   hubs, dist and count), pll-ref also the host ``pll_undirected``;
   parapll's 4096 ``query_with_hub`` answers equal scipy's Dijkstra,
   with at least the CHL's labels; the gll index goes save -> load ->
   serve(qlsn) -> flush, equal to ``query``;
3c. crash matrix: a child process running phase 3's PLaNT build under
   a ``CheckpointManager`` is killed with exit 41 at ``engine.commit``
   after CRASH_AFTER commits; the newest step it left is torn and the
   parent resumes from the one before (warned), equal to phase 3's
   table; a GLL build's steps past its middle flush are dropped and it
   resumes, table and counters equal to the uninterrupted run's;
3d. repair: ``CHLIndex.apply`` on phase 3's index, twice, with one live
   cached ``serve`` and a ``RepairJournal``: a batch that joins tied
   paths around slack edges (delete one, reweight another down to its
   endpoints' distance, insert a shortcut one below a two-hop
   distance), then a low-load batch (the delete, reweight and insert of
   smallest non-empty shadow among seeded candidates). After each, the
   repaired table equals a fresh card build on the mutated graph, the
   pre-mutation service answers 4096 cached pairs equal to Dijkstra on
   it (some moved), and the journal recovers the saved artifact as
   post-repair; affected share and the repair and rebuild walls are
   logged;
3e. directed exactness: random_connected(4096, 8192 extra arcs,
   directed), degree ranking, a full ``build(algo="directed")`` at
   batch 16 (PLaNT on G into L_in and on its reverse into L_out each
   batch); 65,536 pairs served through ``serve(mode="qlsn")`` (one
   two-table label_query launch a flush) equal scipy's Dijkstra on the
   digraph; save -> load gives equal tables; a run stopped by a soft
   crash at its second ``engine.commit`` resumes to the uninterrupted
   out and in tables;
3f. sharded exactness: ``build(store="sharded", shards=4)`` on phase 3's
   graph (PLaNT streamed into the hub shards) equals phase 3's table
   re-homed by ``ShardedStore.from_table``; routed serving equals
   Dijkstra and the stacked (dist, hub) the dense store's; save, then
   load as sharded, as dense and re-sharded to K = 3, each equal to its
   re-homing; ``apply`` of phase 3d's low-load batch on a sharded index
   equals the dense repair's table re-homed;
3g. spill and compressed exactness: ``build(store="compressed",
   codec="u16", quant_exact=True, shards=4)`` on phase 3's graph (PLaNT
   streamed, then encoded); 65,536 served pairs (16 Dijkstra sources x
   every target) equal scipy's Dijkstra, the stacked (dist, hub) equal
   the plain version's on CPU copies of the store, hubs real
   witnesses; a bf16 re-encoding's ``max_ulp_err`` equals the CPU
   copy's and its card decode's; the compressed artifact loads
   compressed and dense with the dense build's label sets; the dense
   and a K = 4 artifact load ``store="spill"`` (memory-mapped) and
   serve, routed and unrouted, equal to the dense store; a
   ``spill.query`` io fault quarantines a shard, named by ``health()``;
   a version-1 artifact loads dense and spilled, a version-2 manifest
   loads; ``repro_torch.launch.serve_chl.main`` serves the compressed
   artifact equal to the dense index;
3h. distributed exactness: on phase 3's graph, ``build(g, rank)`` with
   the default plan (the hybrid: eta = 16, Ψ_th from the mesh size) on
   the card's one-node mesh; the hybrid (eta = 16, Ψ_th below 1, so it
   switches to DGLL after its first PLaNT superstep, chl_common's
   compact budget), dgll and plant-dist on 8 logical nodes of the card
   (``NodeMesh.logical(8, "cuda")``); each merged table equals phase 3's
   PLaNT table as label sets, no PLaNT superstep calls a collective and
   every DGLL superstep calls at least one; the hybrid's 65,536 pairs
   (16 Dijkstra sources x every target) through ``serve`` in qlsn, qfdl
   and qdol equal Dijkstra; plant-dist with node 1 silent after
   superstep 2 and a heartbeat monitor of patience 1 declares it lost,
   re-plants its tail on the survivors and lands the same label sets;
   the 8-node hybrid on the card equals the CPU's (partitions, merged
   table, records) on grid_road(24, 24);
4. dense block: scale_free(32,768), the top 64 roots through
   ``plant_fixpoint_dense`` over the 4.3 GB dense weight block (the
   minplus kernel), equal to the ELL engine on the card;
5. road scale: the chl-road configuration, grid_road(4096, 4096)
   (n = 16,777,216, ELL width 8), one PLaNT superstep of one cluster
   node — 8 unpruned trees in batches of 4, label cap 8 — through the
   source-windowed sweep, then 65,536 qlsn queries through the serving
   tier; every label of one root is checked against Dijkstra and the
   served answers against the plain query, and one more flush is split
   into the submit's per-ticket host work, the answer fn (host wall and
   device time) and the flush's draining;
5a. road resume: phase 5's superstep under a ``CheckpointManager`` in
   the git-ignored build/, stopped by a soft crash at its second
   ``engine.commit`` and resumed by a fresh policy and manager, equal
   to phase 5's table; logs each step's bytes, the save (copy to the
   host, npz write), the restore and the fingerprint hash;
5b. GLL road superstep: ``GLLPolicy`` (alpha = 4) through
   ``engine.run`` on phase 5's graph, batch, cap and first batch of 4
   roots (the schedule cut to them), whose table must equal phase 5's
   PLaNT table restricted to those roots; then a profiler window over a
   fresh run's batch and flush, split
   into the relaxation kernel, the sweep loop's mask/frontier ops, the
   distance-query cover (``hub_distance_map`` + ``cover_distance``)
   and ``clean_superstep``;
5c. sharded road: phase 5's first batch of 4 roots (same graph, batch
   and cap) streamed into 4 hub shards through ``StreamingShardSink``
   (each shard one of the 4 trees); the shards equal
   ``hub_partition_arrays`` of phase 5's table restricted to those
   roots, and a ``ShardedStore`` on the card answers phase 5's pairs
   stacked (4 launches and one cross-shard minimum: dist and hub) and
   routed, equal to that table's dense store; the host insert, the
   accumulator's bytes and the stacked query's device time beside
   ``query_table``'s are logged;
5d. spill and compressed road: phase 5c's store encoded by
   ``CompressedStore.from_store(codec="u32", exact=True)`` (its
   partition kept): distances equal the stacked sharded answer and
   (dist, hub) the plain version's on the card; u16 exact raises
   ``QuantRangeError`` (largest distance past 65,534); a bf16 encoding
   logs its ``max_ulp_err``; the store saved (~1.3 GB) and loaded
   ``store="spill"`` with its checksums verified answers routed equal
   to the stacked query; logs the encode walls, label bytes, the
   query's device time and the spill query's host gather, copy and
   kernel;
5e. distributed road: the hybrid on chl_road's configuration (batch 4,
   cap 8, hc_cap 32, compact 4096) over phase 5's graph on 2 logical
   nodes: eta = 2 common trees (the table on the card, then the
   prologue), one HC-pruned PLaNT superstep of 4 trees a node and one
   DGLL superstep of 3 (the queues cut to 8 roots a node), whose emissions
   outgrow the compact budget, so it completes by the dense broadcast;
   the node steps sweep through the windowed kernel only; no collective
   in a PLaNT superstep, at least one in the DGLL superstep; 65,536
   pairs from the 16 processed roots (the top ranks: exact) answer
   qlsn == qfdl == qdol, all finite, and equal scipy's Dijkstra from
   two roots; then a profiler window over 16 HC-pruned sweeps;
6. random scale: random_connected(4,194,304, 4,194,304 extra edges),
   sources spread over all n, at the chl-scalefree configuration's
   batch 4, 8 trees and cap 32, through the source-windowed sweep,
   checked and served as in phase 5;
   phases 5 and 6 end with a profiler window (``torch.profiler``) over
   16 sweeps of the sweep loop (``batched_sssp_maxrank``): the
   device's busy share, each kernel's device time by name, and per
   sweep the relaxation kernel, the loop's own tensor ops and the
   idle time;
7. directed scale: the chl-scalefree configuration on
   random_connected(4,194,304, 4,194,304 extra arcs, directed): the 8
   top-ranked roots through ``DirectedPlantPolicy`` at batch 4, cap 32,
   G and its reverse each through the source-windowed sweep, then
   65,536 queries (h, v) and (v, h) for planted roots h (exact: every
   vertex ranked above h is planted) served in one flush, equal to the
   plain query and, for two roots, to scipy's Dijkstra on G and on its
   transpose; the two-table form is then timed at this state.

Launch counts are set to 0 just before each of phases 3-7 (and each
build of 3b, each resume of 3c, the repair of 3d, the resume of 3e, the
repair of 3f, the spill loads of 3g and of 5d, each build and the query
modes of 3h, the frontier and the road resume) and read just after it;
a phase fails if a kernel of its path was not launched. Each log line
carries the seconds since the start.
Phases 3-6 end by timing their kernels at the path's shapes beside the
plain version and the memory/compute bound: ell_relax on a mid-build
state of the exactness graph (B = 16) and on the two mid-size states,
both relaxation kernels on the same mid-build states of the road and
the random graph (the dense-vs-windowed comparison), minplus at
B = 64, K = N = 32,768, and the serving entry point ``query_table`` on
four states of Q = 65,536 pairs: the exactness build's table (L = 288),
a synthetic full table (L = count = 256, hubs from a shared pool), the
road table (L = 8) and the random table (L = 32), each held equal to
the plain query and shown to be one launch of the hand-written kernel
and no other device work by its profiler window; label_query's operand
form stays timed at the road serving shape, its two-table form (a
directed query) at phase 7's state, and the sharded road store's
stacked query (4 launches) beside ``query_table`` in phase 5c. Each kernel gets three
times: ``ms``, CUDA events around a loop of wrapper calls
(the host may pace it); ``device_ms``, the kernel's own device time per
call from a ``torch.profiler`` window over the same calls; and
``host_us``, the wrapper's host cost per call (``time.perf_counter``,
no synchronisation inside the loop). A relaxation bound counts the
adjacency's finite in-edges, not its padded width; a query bound the
rows' valid prefixes (their counts), not their padded width.
The last lines are the card (``nvidia-smi`` name and power limit), one
JSON object with the per-kernel record, and the result line
``{"ok": true, "device": {...}}``. Without CUDA, or without the rest
of the repository beside it, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import importlib
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

from repro_torch.configs import chl_road, chl_scalefree  # noqa: E402

ROAD = chl_road.CONFIG            # n = 16,777,216 on a square grid
ROAD_ROWS = ROAD_COLS = int(round(ROAD.n ** 0.5))
ROAD_TREES, ROAD_BATCH, ROAD_CAP = (ROAD.trees_per_node, ROAD.batch,
                                    ROAD.cap)
# the paper's shared-memory builds on the exactness graph (3b), and
# BuildPlan's default GLL cleaning threshold, alpha * n labels
SHARED_ALGOS = ("pll-ref", "gll", "lcc", "parapll")
GLL_ALPHA = 4.0
# chl_scalefree's n, batch, trees_per_node and cap on the repo's random
# graph (its ELL width 64 needs hub splitting)
SCALEFREE = chl_scalefree.CONFIG
RANDOM_N = RANDOM_EXTRA = SCALEFREE.n
RANDOM_TREES, RANDOM_BATCH, RANDOM_CAP = (SCALEFREE.trees_per_node,
                                          SCALEFREE.batch, SCALEFREE.cap)
DENSE_N, DENSE_ROOTS = 32_768, 64
EXACT_BATCH = 16
# the dense route's largest states at the road batch of 4: two source
# planes of 8 * 4 * n bytes just under half the H100's 50 MB L2
MID_ROAD_SIDE = 896               # n = 802,816: 25.7 MB of planes
MID_RANDOM_N = 786_432            # 25.2 MB of planes
MID_SWEEPS = {"road-mid": 128, "random-mid": 8}
SERVE_Q = 65_536
# the directed exactness graph (random_connected(4096, 8192 extra arcs,
# directed)) and the hub shards of the sharded phases: K = 4 on the road
# state's first batch gives each shard one of its 4 trees
DIRECTED_EXACT_N = 4096
EXACT_SHARDS = ROAD_SHARDS = 4
# the synthetic full-row query state (no graph behind it): L = count =
# 256, hubs from a shared pool so rows overlap, a table past the L2
SYNTH_N, SYNTH_L, SYNTH_POOL = 262_144, 256, 1024
# the distributed phases: DIST_Q logical nodes on the card at exactness;
# a Ψ threshold below 1 (every label is an explored vertex, so Ψ >= 1)
# switches the hybrid to DGLL after its first PLaNT superstep. The card
# against the CPU on DIST_SMALL_SIDE^2 vertices (the CPU's run of the
# 8-node hybrid at n = 4096 takes about a minute)
DIST_Q, DIST_PSI_LOW, DIST_SMALL_SIDE = 8, 0.5, 24
# the road phase: 2 nodes, one common tree a node (eta = 2), one
# HC-pruned PLaNT superstep of a batch of 4 trees a node, then one DGLL
# superstep of 3 (8 trees a node in all, chl_road's trees_per_node, so
# that its cap of 8 labels a vertex a node holds)
ROAD_NODES, ROAD_ETA, ROAD_DIST_COLS = 2, 2, 8


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log, stamped with the seconds since start
    (the stamps give each phase's share of the run)."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


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


#: the device-side name of each wrapper's kernel, as the profiler shows it
DEVICE_NAMES = {"ell_relax": "ell_relax_kernel",
                "ell_relax_windowed": "relax_tiles_kernel",
                "label_query": "label_query_",
                "minplus": "minplus_kernel"}


def cuda_events(prof):
    """A finished profiler window's device events (kernels and copies):
    name and device span in µs (``.time_range.start``/``.end``), read
    straight from the trace's kineto events, without the host-side
    event tree that ``prof.events()`` builds (tens of seconds for a
    window of 10^5 events)."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType
    return [SimpleNamespace(name=e.name(), time_range=SimpleNamespace(
                start=e.start_ns() / 1e3, end=e.end_ns() / 1e3))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def device_events(fn, reps: int):
    """The device events (kernels and copies) of ``reps`` calls of
    ``fn`` in one ``torch.profiler`` window (CUDA activity only)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return cuda_events(prof)


def device_ms(fn, reps: int, kernel: str):
    """The kernel's own device time per call of ``fn``: the device time
    its events cover in a ``torch.profiler`` window over ``reps`` calls
    (the union of their spans), divided by ``reps``. A window late in a
    long process can come back with no device event at all (PERF.md
    §7), so an empty window is logged and another taken, three in all;
    None when none holds the kernel."""
    for window in range(1, 4):
        got = device_events(fn, reps)
        evs = [e for e in got if DEVICE_NAMES[kernel] in e.name]
        if evs:
            return covered(evs) / 1e3 / reps
        log(f"device time of {kernel}: window {window} of 3 held "
            f"{len(got)} device events of "
            f"{sorted({e.name[:40] for e in got})[:4]}")
    return None


def covered(events) -> float:
    """Microseconds covered by the union of the events' device spans
    (the chained window launches of one windowed sweep overlap)."""
    total, reach = 0.0, -float("inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        total += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return total


def host_us(fn, reps: int, rounds: int = 5) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter`` over
    ``reps`` calls with no synchronisation inside the loop (the wrapper's
    checks, allocations and launch, not the kernel); the median of
    ``rounds`` such loops, since the host's clock is shared."""
    import statistics
    import torch
    fn()
    per_call = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) / reps * 1e6)
    torch.cuda.synchronize()
    return statistics.median(per_call)


def measure(name, kern, plain, reps, plain_reps) -> dict:
    """Event-per-call ms, the kernel's device ms and the host µs per call
    of ``kern``, and the plain version's ms."""
    return {"ms": time_ms(kern, reps=reps),
            "device_ms": device_ms(kern, reps, name),
            "host_us": host_us(kern, reps),
            "plain_ms": time_ms(plain, reps=plain_reps, warmup=1)}


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def max_abs_err(a, b) -> float:
    """Largest |a - b| (inf - inf counts as 0; a finite/inf mismatch
    as inf)."""
    import torch
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=0.0).max()) if d.numel() else 0.0


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def reset(kernels) -> None:
    for k in kernels:
        k.launches = 0


def path_launches(kernels, path, what) -> dict:
    """The launch counts of one phase; fails if a kernel of its path
    was not launched."""
    counts = {k.name: k.launches for k in kernels}
    require(all(counts[name] > 0 for name in path),
            f"{what}: a kernel of its path was not launched: {counts}")
    return counts


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


def forced_cap(n: int, windows: int) -> int:
    """A ``max_window`` that splits n vertices into ``windows``
    source windows."""
    n_bn = -(-n // 128) * 128
    return -(-(-(-n_bn // windows)) // 128) * 128


def windowed_operands(rng, B, n, deg, windows, kind, device):
    """`sweep_operands` and their layout at ``windows`` forced source
    windows. ``kind``: "random"; "hub" (row 7 takes its whole ELL row
    from the first window); "gap" (no source in window 1); "retired"
    (only tree 1 alive); "dead" (no tree alive)."""
    import torch
    from repro_torch.kernels.ell_relax import sweep_layout
    ops = sweep_operands(rng, B, n, deg, "cpu")
    cap = forced_cap(n, windows)
    if kind == "hub":
        ops[4][7] = torch.arange(deg, dtype=torch.int32)
        ops[5][7] = torch.as_tensor(rng.integers(1, 9, deg),
                                    dtype=torch.float32)
    elif kind == "gap":
        es = ops[4]
        ops[4] = torch.where((es >= cap) & (es < 2 * cap), es - cap, es)
    elif kind in ("retired", "dead"):
        ops[3][:] = False
        ops[3][1] = kind == "retired"
    ops = [x.to(device) for x in ops]
    return ops, sweep_layout(ops[4], ops[5], bb=B, max_window=cap)


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


def table_operands(rng, n, L, Q, device):
    """A label table of ``n`` rows at width ``L`` and ``Q`` query pairs
    (the card tests' state): counts 0..L (row 0 empty, row 1 full), hubs
    from a pool of about L (rows repeat hubs), distances 0..4 (ties),
    every 11th row on hubs of its own (disjoint), every 13th pair
    u == v, every 5th u and 7th v a negative id."""
    import numpy as np
    import torch
    from repro_torch import interop
    count = rng.integers(0, L + 1, n).astype(np.int32)
    count[0], count[1] = 0, L
    slot = np.arange(L)[None, :] < count[:, None]
    h = rng.integers(0, max(3, L), (n, L))
    h[::11] += 1_000_000 + np.arange(0, n, 11)[:, None] * L
    h = np.where(slot, h, -1).astype(np.int32)
    d = np.where(slot, rng.integers(0, 5, (n, L)),
                 np.inf).astype(np.float32)
    u = rng.integers(0, n, Q)
    v = rng.integers(0, n, Q)
    v[::13] = u[::13]
    u[::5] -= n
    v[::7] -= n
    return (interop.label_table(h, d, count, device),
            torch.as_tensor(u, device=device),
            torch.as_tensor(v, device=device))


def synthetic_table(dev, n, L, pool, seed, same_row=False, count=None):
    """A label table made on the card from ``seed``: ``count`` (default
    L) labels a row, hubs from a pool of ``pool`` ids, so rows overlap,
    integral distances below 2^20, and (-1, +inf) past the count; with
    ``same_row`` every row holds the same hubs in the same order (as one
    superstep of ``count`` trees leaves the road and random tables).
    Synthetic: no graph behind it."""
    import torch
    from repro_torch.core.labels import LabelTable
    c = L if count is None else count
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if same_row:
        hubs = torch.randint(0, pool, (1, L), generator=g, device=dev,
                             dtype=torch.int32).expand(n, L).contiguous()
    else:
        hubs = torch.randint(0, pool, (n, L), generator=g, device=dev,
                             dtype=torch.int32)
    dist = torch.randint(0, 1 << 20, (n, L), generator=g,
                         device=dev).float()
    hubs[:, c:] = -1
    dist[:, c:] = torch.inf
    return LabelTable(hubs, dist,
                      torch.full((n,), c, dtype=torch.int32, device=dev))


def query_pairs_in_chunks(table, u, v):
    """The plain query (`labels.query_pairs`) over query chunks that keep
    its [q, L, L] cube near 2^28 elements; it is per query, so the
    chunks change no answer."""
    import torch
    from repro_torch.core import labels as lbl
    step = max(1, 2 ** 28 // max(1, table.cap ** 2))
    parts = [lbl.query_pairs(table, u[i:i + step], v[i:i + step])
             for i in range(0, u.shape[0], step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def minplus_operands(rng, B, K, N, device):
    """Random (min, +) operands: integral distances and weights (many
    equal candidates), unreachable rows, +inf off-edge weights."""
    import numpy as np
    import torch
    dist = np.where(rng.random((B, K)) < 0.6, rng.integers(0, 10, (B, K)),
                    np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 100, (B, K)),
                     -1).astype(np.int32)
    w = np.where(rng.random((K, N)) < 0.3, rng.integers(1, 10, (K, N)),
                 np.inf).astype(np.float32)
    return [torch.as_tensor(x, device=device) for x in (dist, mrank, w)]


def bound(bytes_: float, ops: float):
    """(ms, "bytes" | "operations"): the larger of the two times at the
    card's peak rates."""
    tb, to = bytes_ / PEAK_BYTES_PER_S, ops / PEAK_OPS_PER_S
    return max(tb, to) * 1e3, "bytes" if tb >= to else "operations"


def relax_bound_ms(B, n, E, live):
    """The least time for one sweep, of either relaxation kernel, over
    an adjacency of ``E`` finite in-edges (the padding carries no
    work). The edges (source and weight) and the rank row are read
    once, dist/mrank of every tree and prop of each live one, and two
    [B, n] planes written; the fold's add/compare/max per live in-edge
    runs at the f32 rate."""
    adj = (8 * E + 4 * n) if live else 0
    return bound(adj + B + 8 * B * n + 4 * live * n + 8 * B * n,
                 3 * live * E)


def label_query_bound_ms(Q, L):
    """The operand form: four [Q, L] operand reads and two [Q] outputs,
    and Q * L * L hub compares at the f32 rate."""
    return bound(16 * Q * L + 8 * Q, Q * L * L)


def query_table_bound_ms(table, u, v):
    """The table form, counted from this run's rows: per query the two
    int64 ids, the two counts, the valid prefix of both rows (hub and
    distance, 8 B a slot) and the two outputs; count_u * count_v hub
    compares at the f32 rate."""
    cu = table.count[u].double()
    cv = table.count[v].double()
    Q = u.shape[0]
    return bound(Q * (16 + 8 + 8) + 8 * float((cu + cv).sum()),
                 float((cu * cv).sum()))


def stacked_bound_ms(store, u, v):
    """The sharded query as a function, counted from this run's rows: the
    two int64 ids of each query once, each endpoint's count in every
    shard (8 B a shard a query), the valid prefix of every shard row
    (8 B a slot) and one (dist, hub) answer; count_u * count_v hub
    compares a shard at the f32 rate. Returns (bound, the stacked
    design's bound): the design also re-reads the ids in each of its K
    launches and writes K partial (dist, hub) pairs that the cross-shard
    minimum reads back."""
    K, Q = store.num_shards, u.shape[0]
    cu = store.count[:, u].double()
    cv = store.count[:, v].double()
    fn_bytes = Q * (16 + 8 * K + 8) + 8 * float((cu + cv).sum())
    ops = float((cu * cv).sum())
    extra = (K - 1) * 16 * Q + 2 * 8 * K * Q
    return bound(fn_bytes, ops), bound(fn_bytes + extra, ops)


def minplus_bound_ms(B, K, N):
    """W, dist and mrank read once, two [B, N] planes written, and an
    add, a compare and a select per (b, u, v) at the f32 rate."""
    return bound(4 * K * N + 8 * B * K + 8 * B * N, 3 * B * K * N)


def record(name, source, replaces, launches, err, ms, plain_ms, bnd,
           **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            **extra}


# -------------------------------------------------------------- phases

def phase_parity(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.ell_relax import (ell_relax, ell_relax_windowed,
                                               ell_sweep_bucketed_plain,
                                               ell_sweep_plain)
    from repro_torch.kernels.ell_relax.layout import TILE_EDGES
    from repro_torch.kernels.label_query import (label_query,
                                                 label_query_ref, query_table)
    from repro_torch.kernels.minplus import minplus, minplus_plain
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
    hub = 2 * TILE_EDGES + 512
    cases = ((300, 1, 3, "random"), (4097, 17, 2, "random"),
             (1000, 8, 3, "random"), (777, 40, 7, "random"),
             (2000, 6, 4, "random"), (hub, hub // 2, 2, "hub"),
             (1000, 8, 4, "gap"))
    runs = [(B,) + c for B in (1, 3, 4, 5, 32, 33) for c in cases]
    runs += [(B, 1000, 8, 3, kind) for B in (4, 5)
             for kind in ("retired", "dead")]
    for B, n, deg, windows, kind in runs:
        ops, lay = windowed_operands(rng, B, n, deg, windows, kind, dev)
        require(lay.num_windows == windows,
                f"layout of n={n} has {lay.num_windows} windows")
        kd, km = ell_relax_windowed(*ops[:4], lay, ops[6])
        pd, pm = ell_sweep_bucketed_plain(*ops[:4], lay, ops[6])
        torch.cuda.synchronize()
        require(torch.equal(kd, pd) and torch.equal(km, pm),
                f"ell_relax_windowed != plain at B={B} n={n} "
                f"deg={deg} windows={windows} ({kind})")
    log("parity ell_relax_windowed: torch.equal to the bucketed plain "
        "sweep at B in {1,3,4,5,32,33} x (n, deg, windows) in "
        "{(300,1,3),(4097,17,2),(1000,8,3),(777,40,7),(2000,6,4)}, a hub "
        f"row of {hub // 2} in-edges from one window (past a tile's "
        f"{TILE_EDGES}-edge buffer), an empty window; only one tree "
        "alive, none alive — inf padding, ties")
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
    log("parity label_query (operand form): torch.equal (dist, hub) at L "
        "in {8,288,700} x Q in {1,45,1000} — ties, disjoint rows, -1 "
        "inside rows")
    for L in (1, 3, 8, 9, 32, 33, 288, 700):
        for Q in (1, 45, 1000, 65_537):
            table, u, v = table_operands(rng, 3000, L, Q, dev)
            kd, kh = query_table(table, u, v)
            pd, ph = query_pairs_in_chunks(table, u, v)
            torch.cuda.synchronize()
            require(torch.equal(kd, pd) and torch.equal(kh, ph),
                    f"query_table != plain at Q={Q} L={L}")
    log("parity label_query (table form, query_table): torch.equal "
        "(dist, hub) at L in {1,3,8,9,32,33,288,700} x Q in "
        "{1,45,1000,65537} — counts 0..L, repeated hubs, ties, disjoint "
        "rows, u == v, negative ids")
    for B, K, N in ((1, 1, 1), (3, 5, 7), (8, 128, 128), (64, 130, 250),
                    (70, 333, 65)):
        ops = minplus_operands(rng, B, K, N, dev)
        kd, km = minplus(*ops)
        pd, pm = minplus_plain(*ops)
        torch.cuda.synchronize()
        require(torch.equal(kd, pd) and torch.equal(km, pm),
                f"minplus != plain at B={B} K={K} N={N}")
    kd, km = minplus(torch.full((8, 130), torch.inf, device=dev),
                     torch.full((8, 130), -1, dtype=torch.int32,
                                device=dev),
                     torch.full((130, 129), torch.inf, device=dev))
    require(not bool(torch.isfinite(kd).any()) and bool((km == -1).all()),
            "minplus: all-unreachable must give (+inf, -1)")
    kd, km = minplus(torch.tensor([[1.0, 1.0]], device=dev),
                     torch.tensor([[7, 9]], dtype=torch.int32, device=dev),
                     torch.tensor([[2.0], [2.0]], device=dev))
    require(float(kd[0, 0]) == 3.0 and int(km[0, 0]) == 9,
            "minplus: a tie takes the max rank")
    log("parity minplus: torch.equal at (B, K, N) in {(1,1,1),(3,5,7),"
        "(8,128,128),(64,130,250),(70,333,65)}; all-unreachable -> "
        "(+inf, -1); tie -> max rank")


def phase_exactness(dev, kernels) -> dict:
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.graphs import betweenness_ranking, grid_road
    from repro_torch.index import BuildPlan, CHLIndex, build
    g = grid_road(64, 64, seed=7)
    rank = betweenness_ranking(g, samples=12)
    reset(kernels)
    t0 = time.perf_counter()
    idx = build(g, rank, BuildPlan(algo="plant", batch=EXACT_BATCH),
                device=dev)
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
    counts = path_launches(kernels, ("ell_relax", "label_query"),
                           "exactness")
    sweeps = [r.sweeps for r in idx.report.supersteps]
    log(f"exactness n={g.n}: build {wall:.3f} s, "
        f"{len(sweeps)} supersteps, {sum(sweeps)} sweeps, "
        f"{idx.total_labels} labels (ALS {idx.als:.2f}, cap "
        f"{idx.report.cap}); 4096 query_with_hub == scipy Dijkstra; "
        f"save->load->serve(qlsn)->flush == query; launches {counts}")
    return {"launches": counts, "graph": (g, rank), "table": idx.table,
            "index": idx, "wall": wall, "queries": (u, v, want)}


def same_table(a, b) -> bool:
    """``torch.equal`` on hubs, dist and count."""
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_shared_memory(dev, kernels, exact) -> dict:
    """The paper's shared-memory builds on the exactness graph, each a
    full ``build`` on the card held against phase 3's PLaNT table (gll,
    lcc, pll-ref) or Dijkstra (parapll, which is not minimal)."""
    import numpy as np
    import torch
    from repro_torch.core import labels as lbl
    from repro_torch.core.pll import pll_undirected
    from repro_torch.index import BuildPlan, CHLIndex, build
    g, rank = exact["graph"]
    plant = exact["table"]
    u, v, want = exact["queries"]
    launches = {k.name: 0 for k in kernels}
    walls = {}
    for algo in SHARED_ALGOS:
        reset(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = build(g, rank, BuildPlan(algo=algo, batch=EXACT_BATCH),
                    device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = idx.report
        if algo == "parapll":
            d, hub = idx.query_with_hub(u, v)
            require(np.array_equal(d, want), "parapll: query != Dijkstra")
            require(bool((hub >= 0).all()), "parapll: every pair has a hub")
            require(idx.total_labels >= lbl.total_labels(plant),
                    "parapll: fewer labels than the CHL")
            check = (f"4096 query_with_hub == scipy Dijkstra; "
                     f"{idx.total_labels / lbl.total_labels(plant):.3f}x "
                     "the CHL's labels")
        else:
            require(same_table(idx.table, plant),
                    f"{algo}: table != phase 3's PLaNT table")
            check = "table == PLaNT's (torch.equal)"
        if algo == "pll-ref":
            t1 = time.perf_counter()
            require(lbl.to_numpy_sets(idx.table) == pll_undirected(g, rank),
                    "pll-ref: table != host pll_undirected")
            check += (f"; == host pll_undirected "
                      f"({time.perf_counter() - t1:.1f} s)")
        if algo == "gll":
            d = idx.query(u, v)
            scratch = ROOT / "build"            # git-ignored, in the checkout
            scratch.mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=scratch) as tmp:
                path = idx.save(os.path.join(tmp, "index"))
                idx2 = CHLIndex.load(path, rank=rank, device=dev)
                srv = idx2.serve(mode="qlsn", batch_size=1024)
                srv.submit(u, v)
                out = srv.flush()
            require(np.array_equal(out, d), "gll: served != query")
            require(np.array_equal(d, want), "gll: query != Dijkstra")
            check += "; save->load->serve(qlsn)->flush == query == Dijkstra"
        path = () if algo == "pll-ref" else ("ell_relax",)
        counts = path_launches(kernels, path, algo)
        for name, c in counts.items():
            launches[name] += c
        walls[algo] = wall
        regrows = [e.to_dict() for e in rep.overflow_events]
        log(f"shared-memory {algo} n={g.n} batch {EXACT_BATCH}: build "
            f"{wall:.3f} s (PLaNT {exact['wall']:.3f} s), "
            f"{len(rep.supersteps)} supersteps, cleaned {rep.cleaned}, "
            f"constructed {rep.constructed}, {idx.total_labels} labels "
            f"(ALS {idx.als:.2f}, cap {rep.cap}, overflow events "
            f"{regrows}); {check}; launches {counts}")
    require(launches["label_query"] > 0,
            "shared-memory: the label query was not launched")
    return {"launches": launches, "walls": walls}


def phase_scale(dev, kernels, what, g, rank, batch, trees, cap) -> dict:
    """One cluster node's PLaNT superstep(s) on the card through the
    source-windowed sweep, then SERVE_Q qlsn queries; checks the top
    root's labels against Dijkstra and the served answers against the
    plain query. Returns what the timing and the record need."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core import labels as lbl
    from repro_torch.engine import rank_order, run_build
    from repro_torch.index import BuildPlan, BuildReport, CHLIndex
    from repro_torch.index.store import DenseStore
    from repro_torch.kernels.ell_relax import layout_plan

    roots = rank_order(rank)[:trees]
    plan_w = layout_plan(g.n, dev, bb=batch)
    require(plan_w.num_windows > 1, f"{what}: planes fit one window")
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_build(g, rank, algo="plant", batch=batch, cap=cap,
                    roots_order=roots, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = res.sink.table()
    total = lbl.total_labels(table)
    plan = BuildPlan(algo="plant", batch=batch, cap=cap)
    report = BuildReport(algo="plant", wall_s=wall, total_labels=total,
                         als=total / g.n, cap=cap,
                         supersteps=list(res.records))
    idx = CHLIndex(DenseStore(table), plan=plan, report=report, rank=rank)
    rng = np.random.default_rng(5)
    u = rng.integers(0, g.n, SERVE_Q)
    v = rng.integers(0, g.n, SERVE_Q)
    srv = idx.serve(mode="qlsn", batch_size=SERVE_Q)
    t1 = time.perf_counter()
    srv.submit(u, v)
    served = srv.flush()
    serve_wall = time.perf_counter() - t1
    launches = path_launches(kernels, ("ell_relax_windowed", "label_query"),
                             what)

    sweeps = sum(r.sweeps for r in res.records)
    bnd, by = relax_bound_ms(batch, g.n, int(np.isfinite(g.ell_w).sum()),
                             batch)
    log(f"{what} build: {len(res.records)} supersteps x {batch} trees, "
        f"{sweeps} sweeps over {plan_w.num_windows} source windows of "
        f"{plan_w.window}, {total} labels, wall {wall:.2f} s, "
        f"{wall / max(1, sweeps) * 1e3:.3f} ms per sweep end to end "
        f"(kernel bound {bnd:.3f} ms per sweep, {by}); launches "
        f"{launches}")
    log(f"{what} serve: {SERVE_Q} qlsn queries in one launch, host wall "
        f"{serve_wall:.3f} s")

    # f32 path sums are exact only below 2^24
    finite = table.dist[torch.isfinite(table.dist)]
    dmax = float(finite.max())
    require(dmax < 2 ** 24, f"{what}: largest label distance {dmax} "
            ">= 2^24")
    # every label of the top root against Dijkstra
    r = int(roots[0])
    A = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                      shape=(g.n, g.n))
    t1 = time.perf_counter()
    D = dijkstra(A, indices=r)
    hubs = table.hubs.cpu().numpy()
    dist = table.dist.cpu().numpy()
    vs, ks = np.nonzero(hubs == r)
    require(len(vs) == g.n, f"{what}: top root labels {len(vs)} of {g.n}")
    require(np.array_equal(dist[vs, ks], D[vs].astype(np.float32)),
            f"{what}: root labels != Dijkstra")
    log(f"{what} check: largest label distance {dmax:.0f} < 2^24; all "
        f"{len(vs)} labels of root {r} == scipy Dijkstra "
        f"({time.perf_counter() - t1:.1f} s)")
    plain, _ = lbl.query_pairs(table, torch.as_tensor(u, device=dev),
                               torch.as_tensor(v, device=dev))
    require(np.array_equal(served, plain.cpu().numpy()),
            f"{what}: served != plain query")
    require(bool(np.isfinite(served).all()), f"{what}: every pair shares "
            "the top root, so every answer is finite")
    log(f"{what} serve: {SERVE_Q} served answers == plain query_pairs")
    serve_split(idx, u, v, what)
    return {"launches": launches, "roots": roots, "table": table,
            "dijkstra": (r, D),
            "records": res.records, "u": u, "v": v, "wall": wall}


def serve_split(idx, u, v, what) -> None:
    """One more SERVE_Q-query flush through a fresh ``QueryService`` on
    the index's qlsn answer fn, split into the submit's own host time
    (its per-ticket Python), the answer fn (its host wall, and the
    stream span that CUDA events around it cover: the index copies, the
    kernel and the copy back) and the flush's draining of tickets."""
    import torch
    from repro_torch.serve import QueryService, make_answer_fn
    answer = make_answer_fn(idx.store, "qlsn")
    spans = []

    def timed(uu, vv):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = answer(uu, vv)
        ev[1].record()
        spans.append(ev)
        return out

    srv = QueryService(timed, batch_size=SERVE_Q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.submit(u, v)                # the last ticket fills the batch
    t1 = time.perf_counter()
    srv.flush()
    t2 = time.perf_counter()
    require(len(spans) == 1, f"{what} serve split: {len(spans)} launches")
    st = srv.stats_
    host = st.warmup_s + st.busy_s
    stream = spans[0][0].elapsed_time(spans[0][1])
    log(f"{what} serve split: {SERVE_Q} queries in {t2 - t0:.4f} s: "
        f"submit's per-ticket host work {t1 - t0 - host:.4f} s "
        f"({(t1 - t0 - host) / (t2 - t0) * 100:.1f} %), the answer fn "
        f"{host * 1e3:.3f} ms of host wall ({host / (t2 - t0) * 100:.2f} "
        f"%; its stream span {stream:.4f} ms by CUDA events), the "
        f"flush's draining {t2 - t1:.4f} s")


def gll_road_policy(dev, g, rank, roots):
    """GLLPolicy at the road configuration with its schedule cut to
    ``roots`` (the reference's policy takes no root order; a rank-order
    prefix labels exactly what PLaNT does with those roots)."""
    from repro_torch.engine import BatchSchedule, GLLPolicy
    policy = GLLPolicy(g, rank, batch=ROAD_BATCH, cap=ROAD_CAP, device=dev,
                       alpha=GLL_ALPHA)
    policy.schedule = lambda: BatchSchedule(roots, ROAD_BATCH)
    return policy


def first_trees_table(table, roots, k):
    """Phase 5's table as a build of its first ``k`` roots alone would
    leave it: the labels of ``roots[k:]`` dropped, each row compacted
    in order (its first batch's labels come first in every row)."""
    import torch
    from repro_torch.core import labels as lbl
    later = torch.as_tensor(roots[k:], device=table.hubs.device)
    return lbl.delete_mask(table, torch.isin(table.hubs, later))


def phase_gll_road(dev, kernels, g, rank, road) -> dict:
    """One GLL superstep on the road state through ``engine.run`` over
    phase 5's first batch of roots (ROAD_BATCH of its ROAD_TREES: a cut
    in depth), held against phase 5's PLaNT table restricted to those
    roots, then its time split."""
    import torch
    from repro_torch.core import labels as lbl
    from repro_torch.engine import DenseSink, run
    roots = road["roots"][:ROAD_BATCH]
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(gll_road_policy(dev, g, rank, roots),
              DenseSink(g.n, ROAD_CAP, dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(kernels, ("ell_relax_windowed",), "gll road")
    table = res.sink.table()
    require(same_table(table, first_trees_table(road["table"], road["roots"],
                                                ROAD_BATCH)),
            "gll road: table != phase 5's PLaNT table of the same roots")
    c = res.counters
    log(f"gll road superstep: {len(res.records)} supersteps of "
        f"{[r.trees for r in res.records]} trees, {len(roots)} roots in "
        f"one batch, alpha {GLL_ALPHA}: wall {wall:.2f} s (phase 5's PLaNT "
        f"superstep {road['wall']:.2f} s for {ROAD_TREES} roots in "
        f"batches of {ROAD_BATCH}), constructed {c['constructed']}, "
        f"cleaned {c['cleaned']}, {lbl.total_labels(table)} labels; table "
        f"== phase 5's PLaNT table of these roots (torch.equal); launches "
        f"{launches}")
    del res, table
    split = gll_road_split(dev, g, rank, roots)
    return {"launches": launches, "wall": wall, "split": split}


def gll_road_split(dev, g, rank, roots) -> dict:
    """A fresh GLL run on the road roots (one batch): a
    ``torch.profiler`` window (CUDA activity) over the batch and the
    flush, with CUDA events around the same span. The window gives the
    device's busy time and the relaxation kernel's; the distance-query
    cover (both tables' ``hub_distance_map`` + ``cover_distance``, on
    the state the batch starts from: its work does not depend on the
    values) and ``clean_superstep`` (on the flush's emissions, at its
    shapes) are timed apart with CUDA events; the sweep loop's
    mask/frontier ops are the rest of the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import labels as lbl
    from repro_torch.core.gll import clean_superstep
    from repro_torch.engine import DenseSink
    from repro_torch.kernels.ell_relax import WINDOWED_KERNEL
    policy = gll_road_policy(dev, g, rank, roots)
    sink = DenseSink(g.n, ROAD_CAP, dev)
    steps = list(policy.schedule().steps())
    require(len(steps) == 1, "gll road split: want one batch")
    roots2 = torch.as_tensor(steps[0].roots, device=dev)

    def cover():
        return torch.minimum(
            lbl.cover_distance(sink.table(),
                               lbl.hub_distance_map(sink.table(), roots2)),
            lbl.cover_distance(policy.loc,
                               lbl.hub_distance_map(policy.loc, roots2)))
    cover_ms = time_ms(cover, reps=3, warmup=1)
    pending = []
    flush = policy._flush

    def keep_pending(sink_):
        pending.extend(policy.pending)
        return flush(sink_)
    policy._flush = keep_pending
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    before = WINDOWED_KERNEL.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        out = policy.step(steps[0], sink) or policy.epilogue(sink)
        ev[1].record()
        torch.cuda.synchronize()
    host = time.perf_counter() - t0
    sweeps = WINDOWED_KERNEL.launches - before      # one launch a sweep
    require(out is not None and out.record.trees == len(roots),
            "gll road split: the window holds no flush of all roots")
    stream_ms = ev[0].elapsed_time(ev[1])
    roots_t = torch.cat([b.roots for b in pending])
    emit = torch.cat([b.emit for b in pending])
    dist = torch.cat([b.dist for b in pending])
    table = sink.table()
    clean_ms = time_ms(lambda: clean_superstep(
        table, table, policy.arrays.rank, roots_t, emit, dist),
        reps=3, warmup=1)
    t1 = time.perf_counter()
    kern = cuda_events(prof)
    parse = time.perf_counter() - t1
    split = {"stream_ms": stream_ms, "host_s": host, "cover_ms": cover_ms,
             "clean_ms": clean_ms, "sweeps": sweeps}
    if not kern:
        log(f"gll road split: the profile holds no device time; stream "
            f"span {stream_ms:.1f} ms by CUDA events, cover {cover_ms:.3f}"
            f" ms, clean {clean_ms:.3f} ms; relaxation kernel and sweep loop "
            "ops not measured")
        return split
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    busy = covered(kern) / 1e3
    relax = covered([e for e in kern if "relax" in e.name]) / 1e3
    loop_ops = busy - relax - cover_ms - clean_ms
    split.update(span_ms=span, busy_ms=busy, relax_ms=relax,
                 loop_ops_ms=loop_ops, events=len(kern))
    per = max(1, sweeps)
    log(f"gll road split (the batch, {sweeps} sweeps, + flush; "
        f"{len(kern)} device events, profile parsed in {parse:.1f} s): "
        f"host wall {host:.2f} s, stream span {stream_ms:.1f} ms (CUDA "
        f"events), device span {span:.1f} ms, busy {busy:.1f} ms "
        f"({busy / span * 100:.1f} %): relaxation kernel {relax:.1f} ms "
        f"({relax / busy * 100:.1f} % of busy, {relax / per:.4f} ms a "
        f"sweep), the sweep loop's mask/frontier ops {loop_ops:.1f} ms "
        f"({loop_ops / busy * 100:.1f} %, {loop_ops / per:.4f} ms a sweep), "
        f"hub_distance_map + cover_distance {cover_ms:.3f} ms "
        f"({cover_ms / busy * 100:.3f} %), clean_superstep "
        f"{clean_ms:.3f} ms ({clean_ms / busy * 100:.3f} %), idle "
        f"{span - busy:.1f} ms")
    return split


# ------------------------------------------- resume, faults and repair

def timed_manager(directory, keep):
    """A ``CheckpointManager`` that records, per save, the bytes of the
    state, the copy to the host (on the caller's thread) and the npz
    write (on the writer thread), and each restore's wall."""
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten

    class Timed(CheckpointManager):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.saves, self.writes, self.restores = [], [], []

        def save(self, step, state, data_state=None, blocking=True):
            self.wait()
            nbytes = sum(v.numel() * v.element_size()
                         if isinstance(v, torch.Tensor) else v.nbytes
                         for _, v in flatten(state))
            t0 = time.perf_counter()
            super().save(step, state, data_state, blocking)
            self.saves.append({"step": step, "bytes": nbytes, "at": t0,
                               "copy_s": time.perf_counter() - t0})

        def _write(self, step, host, data_state):
            t0 = time.perf_counter()
            super()._write(step, host, data_state)
            self.writes.append(time.perf_counter() - t0)

        def restore(self, template, step=None):
            t0 = time.perf_counter()
            out = super().restore(template, step)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.restores.append(time.perf_counter() - t0)
            return out

    return Timed(str(directory), keep=keep)


def phase_road_resume(dev, kernels, g, rank, road) -> dict:
    """Phase 5's road superstep run under a checkpoint manager, stopped
    by a soft crash at its second ``engine.commit``, then resumed from
    the first commit by a fresh policy and manager: the table must equal
    phase 5's uninterrupted one. Logs the bytes and walls of the saves
    (copy to the host, npz write), the restore and the fingerprint."""
    import shutil
    import torch
    from repro_torch.engine import DenseSink, PlantPolicy, run
    from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
    ckdir = ROOT / "build" / "road_ckpt"     # git-ignored, in the checkout
    shutil.rmtree(ckdir, ignore_errors=True)
    roots = road["roots"]

    def policy():
        return PlantPolicy(g, rank, batch=ROAD_BATCH, device=dev,
                           roots_order=roots)

    reset(kernels)
    p1 = policy()
    t0 = time.perf_counter()
    fp = p1.fingerprint                      # hashed on first read
    hash_s = time.perf_counter() - t0
    mgr = timed_manager(ckdir, keep=1)
    fplan = FaultPlan({"engine.commit": [Fault("crash", after=1)]})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with faults(fplan):
            run(p1, DenseSink(g.n, ROAD_CAP, dev), ckpt=mgr)
        raise AssertionError("road resume: the run was not stopped")
    except InjectedCrash as e:
        require(e.site == "engine.commit" and fplan.fired == [
            ("engine.commit", "crash")], f"road resume: crashed at {e.site}")
    crash_s = time.perf_counter() - t0
    mgr.wait()
    first = mgr.saves[0]
    superstep_s = first["at"] - t0
    require(mgr.all_steps() == [ROAD_BATCH], "road resume: committed steps "
            f"{mgr.all_steps()}, want [{ROAD_BATCH}]")
    del p1
    torch.cuda.empty_cache()

    mgr2 = timed_manager(ckdir, keep=1)
    p2 = policy()
    t1 = time.perf_counter()
    require(p2.fingerprint == fp, "road resume: fingerprint differs")
    hash2_s = time.perf_counter() - t1
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run(p2, DenseSink(g.n, ROAD_CAP, dev), ckpt=mgr2, resume=True)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    launches = path_launches(kernels, ("ell_relax_windowed",),
                             "road resume")
    require(res.resumed_from == ROAD_BATCH,
            f"road resume: resumed from {res.resumed_from}")
    require(same_table(res.sink.table(), road["table"]),
            "road resume: table != phase 5's uninterrupted road table")
    require(len(res.records) == len(road["records"]),
            "road resume: records lost")
    table_bytes = g.n * ROAD_CAP * 8 + g.n * 4
    last = mgr2.saves[-1]
    log(f"road resume n={g.n}: a soft crash at the second engine.commit "
        f"after {crash_s:.2f} s; resumed from root cursor "
        f"{res.resumed_from} in {resume_s:.2f} s (restore "
        f"{mgr2.restores[0]:.3f} s, then the second batch and its save); "
        f"table == phase 5's uninterrupted road table (torch.equal); "
        f"launches {launches}")
    log(f"road resume checkpoint: {first['bytes']:,} B a step "
        f"(table {table_bytes:,} B = n x {ROAD_CAP} x (4 + 4) + n x 4, and "
        f"the records); first superstep {superstep_s:.2f} s; save: copy "
        f"to the host {first['copy_s']:.3f} s, npz write "
        f"{mgr.writes[0]:.3f} s on the writer thread (resumed run's save "
        f"{last['copy_s']:.3f} + {mgr2.writes[-1]:.3f} s); restore "
        f"{mgr2.restores[0]:.3f} s; fingerprint of the "
        f"{(g.ell_src.nbytes + g.ell_w.nbytes) * 2 / 1e9:.2f} GB adjacency "
        f"(as int64 + f64) and rank: {hash_s:.2f} s, again on resume "
        f"{hash2_s:.2f} s")
    require(first["bytes"] >= table_bytes, "road resume: step bytes")
    del res
    shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"launches": launches, "bytes": first["bytes"],
            "copy_s": first["copy_s"], "write_s": mgr.writes[0],
            "restore_s": mgr2.restores[0], "hash_s": hash_s,
            "superstep_s": superstep_s}


#: the exactness crash matrix's child: a PLaNT build of phase 3's graph
#: under a checkpoint manager (the rank comes from the parent)
CRASH_CHILD = """
import sys
import numpy as np
from repro_torch.checkpoint import CheckpointManager
from repro_torch.graphs import grid_road
from repro_torch.index import BuildPlan, build
g = grid_road(64, 64, seed=7)
build(g, np.load(sys.argv[1]), BuildPlan(algo="plant", batch=int(sys.argv[3])),
      ckpt=CheckpointManager(sys.argv[2], keep=3))
print("finished")
"""
#: commits the child makes before the hard crash (of 256)
CRASH_AFTER = 128


def phase_crash_matrix(dev, kernels, exact) -> dict:
    """Hard and soft crashes on the exactness graph, each resumed to the
    uninterrupted table: (a) a child process running a PLaNT build is
    killed with exit 41 at ``engine.commit`` after CRASH_AFTER commits;
    the newest step it left is torn, and the parent resumes from the one
    before it; (b) a GLL build's checkpoints past its middle flush are
    dropped and the build resumed, equal to the uninterrupted GLL table
    and counters."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import run_build
    from repro_torch.ft import Fault, FaultPlan, torn_write
    from repro_torch.ft.harness import assert_child_killed, run_child
    g, rank = exact["graph"]
    launches = {k.name: 0 for k in kernels}
    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        np.save(os.path.join(tmp, "rank.npy"), rank)
        ckdir = os.path.join(tmp, "plant")
        plan = FaultPlan({"engine.commit": [Fault("crash", after=CRASH_AFTER,
                                                  hard=True)]})
        t0 = time.perf_counter()
        proc = run_child(["-c", CRASH_CHILD, os.path.join(tmp, "rank.npy"),
                          ckdir, str(EXACT_BATCH)], plan=plan,
                         env={"PYTHONPATH": str(ROOT / "src")}, timeout=600)
        child_s = time.perf_counter() - t0
        assert_child_killed(proc)
        require("finished" not in proc.stdout, "crash matrix: the child "
                "finished")
        probe = CheckpointManager(ckdir, keep=3)
        steps = probe.all_steps()
        newest = probe.latest_intact_step()
        require(len(steps) >= 2 and newest == steps[-1] and newest <= (
            CRASH_AFTER * EXACT_BATCH), f"crash matrix: the child left "
            f"steps {steps}")
        torn_write(os.path.join(probe._step_dir(newest), "arrays.npz"), 0.5)
        mgr = CheckpointManager(ckdir, keep=3)   # verifies afresh
        reset(kernels)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = run_build(g, rank, algo="plant", batch=EXACT_BATCH,
                            device=dev, ckpt=mgr, resume=True)
        torch.cuda.synchronize()
        counts = path_launches(kernels, ("ell_relax",), "crash matrix plant")
        require(res.resumed_from == steps[-2], f"crash matrix: resumed from "
                f"{res.resumed_from}, want the step before the torn "
                f"{newest}: {steps[-2]}")
        require(any("skipping corrupt" in str(w.message) for w in caught),
                "crash matrix: no warning for the torn step")
        require(same_table(res.sink.table(), exact["table"]),
                "crash matrix: resumed PLaNT table != phase 3's")
        for name, c in counts.items():
            launches[name] += c
        log(f"crash matrix plant: child killed with exit "
            f"{proc.returncode} at engine.commit after {CRASH_AFTER} "
            f"commits ({child_s:.1f} s, process start included), steps "
            f"left {steps}; newest torn -> resumed from {res.resumed_from}"
            f" (warned), table == phase 3's (torch.equal); launches {counts}")

        gmgr = CheckpointManager(os.path.join(tmp, "gll"), keep=1000)
        reset(kernels)
        full = run_build(g, rank, algo="gll", batch=EXACT_BATCH, device=dev,
                         ckpt=gmgr)
        gsteps = gmgr.all_steps()
        require(len(gsteps) >= 3, f"crash matrix: gll committed {gsteps}")
        require(same_table(full.sink.table(), exact["table"]),
                "crash matrix: checkpointed gll table != PLaNT's")
        mid = gsteps[len(gsteps) // 2 - 1]
        for s in gsteps[len(gsteps) // 2:]:
            __import__("shutil").rmtree(gmgr._step_dir(s))
        res = run_build(g, rank, algo="gll", batch=EXACT_BATCH, device=dev,
                        ckpt=CheckpointManager(os.path.join(tmp, "gll"),
                                               keep=1000), resume=True)
        torch.cuda.synchronize()
        counts = path_launches(kernels, ("ell_relax",), "crash matrix gll")
        require(res.resumed_from == mid, f"crash matrix: gll resumed from "
                f"{res.resumed_from}, want {mid}")
        require(same_table(res.sink.table(), full.sink.table())
                and res.counters == full.counters,
                "crash matrix: resumed gll != uninterrupted (table or "
                "counters)")
        for name, c in counts.items():
            launches[name] += c
        log(f"crash matrix gll: {len(gsteps)} flush commits; dropped those "
            f"past {mid}, resumed from {res.resumed_from}: table and "
            f"counters {res.counters} == the uninterrupted run's; launches "
            f"{counts}")
    return {"launches": launches}


def _csr(g):
    import numpy as np
    import scipy.sparse as sp
    return sp.csr_matrix((g.weights.astype(np.float64), g.indices,
                          g.indptr), shape=(g.n, g.n))


def _edges(g):
    """(u, v, w) of each undirected edge once, u < v."""
    import numpy as np
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    keep = src < g.indices
    return src[keep], g.indices[keep], g.weights[keep]


def _shadow(du, dv, w) -> int:
    """How many trees an edge of weight ``w`` between the endpoints of
    the distance planes ``du``, ``dv`` lies on a shortest or tied path
    of: the frontier's own test, on the host."""
    import numpy as np
    w = np.float32(w)
    du, dv = du.astype(np.float32), dv.astype(np.float32)
    return int(((np.isfinite(du) & (du + w <= dv))
                | (np.isfinite(dv) & (dv + w <= du))).sum())


def _two_hop(g, a, d, exclude):
    """Vertices two hops from ``a``, not adjacent to it, at distance at
    least 2, whose edge to ``a`` is not in ``exclude``."""
    nbrs = set(g.indices[g.indptr[a]:g.indptr[a + 1]].tolist())
    return sorted({x for y in nbrs
                   for x in g.indices[g.indptr[y]:g.indptr[y + 1]].tolist()
                   if x != a and x not in nbrs and d[x] >= 2
                   and (min(a, x), max(a, x)) not in exclude})


def tie_mutations(g, rng):
    """Three mutations around slack edges (weight above the endpoints'
    distance): delete one (no shortest or tied path crosses it),
    reweight another down to its endpoints' distance (it joins their
    tied shortest paths), and insert a shortcut from that edge's first
    endpoint to a vertex two hops away, one below their distance."""
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.dynamic import (EdgeDelete, EdgeInsert, EdgeReweight,
                                     MutationBatch)
    A = _csr(g)
    eu, ev, ew = _edges(g)
    slack = []
    for i in rng.permutation(len(eu)):
        u, v = int(eu[i]), int(ev[i])
        d = dijkstra(A, indices=u)
        if d[v] < ew[i]:
            slack.append((u, v, float(d[v]), d))
        if len(slack) == 2:
            break
    (du, dv, _, _), (ru, rv, rd, rdist) = slack
    used = {(min(du, dv), max(du, dv)), (min(ru, rv), max(ru, rv))}
    cands = _two_hop(g, ru, rdist, used)
    x = cands[int(rng.integers(len(cands)))]
    batch = MutationBatch([EdgeDelete(du, dv), EdgeReweight(ru, rv, rd),
                           EdgeInsert(ru, x, float(rdist[x] - 1))])
    return batch, ru, (f"delete slack ({du}, {dv}); reweight slack "
                       f"({ru}, {rv}) to d = {rd:.0f}; insert ({ru}, {x}) "
                       f"at d - 1 = {rdist[x] - 1:.0f}")


def low_load_mutations(g, rng, candidates=32):
    """A delete, a reweight (up by one) and a shortcut insert (one below
    a two-hop distance), each the one of ``candidates`` seeded
    candidates whose shadow (`_shadow`, on this graph) is smallest but
    not empty."""
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.dynamic import (EdgeDelete, EdgeInsert, EdgeReweight,
                                     MutationBatch)
    A = _csr(g)
    eu, ev, ew = _edges(g)
    picks = rng.choice(len(eu), 2 * candidates, replace=False)
    ranked = []
    for i in picks:
        u, v = int(eu[i]), int(ev[i])
        D = dijkstra(A, indices=[u, v])
        s = _shadow(D[0], D[1], ew[i])
        if s:
            ranked.append((s, u, v, float(ew[i])))
    ranked.sort()
    (sd, du, dv, _), (sr, ru, rv, rw) = ranked[:2]
    used = {(min(du, dv), max(du, dv)), (min(ru, rv), max(ru, rv))}
    best = None
    for a in rng.choice(g.n, candidates, replace=False):
        a = int(a)
        da = dijkstra(A, indices=a)
        for x in _two_hop(g, a, da, used)[:4]:
            s = _shadow(da, dijkstra(A, indices=x), da[x] - 1)
            if s and (best is None or s < best[0]):
                best = (s, a, x, float(da[x] - 1))
    si, a, x, w = best
    batch = MutationBatch([EdgeDelete(du, dv), EdgeReweight(ru, rv, rw + 1),
                           EdgeInsert(a, x, w)])
    return batch, a, (f"delete ({du}, {dv}) [shadow {sd}]; reweight "
                      f"({ru}, {rv}) {rw:.0f} -> {rw + 1:.0f} [shadow {sr}];"
                      f" insert ({a}, {x}) at {w:.0f} [shadow {si}]")


def phase_repair(dev, kernels, exact) -> dict:
    """``CHLIndex.apply`` on phase 3's full PLaNT index (the largest full
    index the script builds), twice, with one live cached service and a
    repair journal: first a batch that joins tied paths around slack
    edges (`tie_mutations`), then a low-load batch (`low_load_mutations`)
    on the graph the first one made. After each: the repaired table
    equals a fresh card build on the mutated graph; the pre-mutation
    service, whose cache holds the old answers of the same 4096 pairs
    (64 of them from the insert's endpoint), answers them equal to
    Dijkstra on the mutated graph, some of them moved; the journal
    recovers the saved artifact as post-repair."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.dynamic import RepairJournal
    from repro_torch.index import BuildPlan, CHLIndex, build
    g, rank = exact["graph"]
    base = exact["index"]
    idx = CHLIndex(base.store, plan=base.plan, report=base.report,
                   rank=base.rank)
    svc = idx.serve(mode="qlsn", batch_size=1024, cache=8192)
    rng = np.random.default_rng(18)
    pool = rng.choice(g.n, 255, replace=False)
    launches = {k.name: 0 for k in kernels}
    out = {}
    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    for i, (name, make) in enumerate((("ties", tie_mutations),
                                      ("low-load", low_load_mutations))):
        batch, a, what = make(g, rng)
        g_new = batch.apply(g)
        d_old = dijkstra(_csr(g), indices=a)
        d_new = dijkstra(_csr(g_new), indices=a)
        ys = np.flatnonzero(d_new != d_old)[:64]
        ys = np.concatenate([ys, rng.integers(0, g.n, 64 - len(ys))])
        u = np.concatenate([rng.choice(pool, 4032), np.full(64, a)])
        v = np.concatenate([rng.integers(0, g.n, 4032), ys])
        src = np.unique(u)
        row = np.searchsorted(src, u)
        want_old = dijkstra(_csr(g), indices=src)[row, v].astype(np.float32)
        want = dijkstra(_csr(g_new), indices=src)[row, v].astype(np.float32)
        svc.submit(u, v)
        require(np.array_equal(svc.flush(), want_old),
                f"repair {name}: pre-mutation service != Dijkstra")
        with tempfile.TemporaryDirectory(dir=scratch) as tmp:
            art = idx.save(os.path.join(tmp, "index"))
            journal = RepairJournal.for_artifact(art)
            reset(kernels)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = idx.apply(batch, graph=g, journal=journal)
            torch.cuda.synchronize()
            repair_s = time.perf_counter() - t0
            svc.submit(u, v)
            served = svc.flush()
            counts = path_launches(kernels, ("ell_relax", "label_query"),
                                   f"repair {name}")
            idx.save(art)
            state = journal.recover(CHLIndex.load(art, rank=rank,
                                                  device=dev))
            require(state == "post" and journal.pending() is None,
                    f"repair {name}: journal recovered {state!r}")
        for k, c in counts.items():
            launches[k] += c
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = build(g_new, rank, BuildPlan(algo="plant", batch=EXACT_BATCH,
                                             cap=rep.cap), device=dev)
        torch.cuda.synchronize()
        rebuild_s = time.perf_counter() - t0
        require(same_table(idx.table, fresh.table), f"repair {name}: "
                "repaired table != a fresh card build on the mutated graph")
        moved = int((want != want_old).sum())
        require(np.array_equal(served, want) and moved > 0,
                f"repair {name}: served answers != Dijkstra on the mutated "
                f"graph, or none moved ({moved})")
        require(svc.stats_.invalidations == i + 1,
                f"repair {name}: {svc.stats_.invalidations} invalidations")
        log(f"repair {name} n={g.n}: {what}; affected {rep.affected} of "
            f"{g.n} trees ({rep.affected / g.n * 100:.2f} %), invalidated "
            f"{rep.invalidated}, repaired {rep.repaired}, {rep.waves} "
            f"waves, {rep.total_labels} labels (cap {rep.cap}); repair "
            f"wall {repair_s:.3f} s against a fresh card build "
            f"{rebuild_s:.3f} s ({repair_s / rebuild_s * 100:.1f} %); "
            f"repaired table == the fresh build (torch.equal); the "
            f"pre-mutation service's 4096 answers == scipy Dijkstra on the "
            f"mutated graph ({moved} moved from their cached values), "
            f"invalidation {i + 1}; journal recover -> 'post'; launches "
            f"{counts}")
        out[name] = {"repair_s": repair_s, "rebuild_s": rebuild_s,
                     "affected": rep.affected, "batch": batch, "graph": g,
                     "table": idx.table}
        g = g_new
    return {"launches": launches, **out}


def phase_frontier_mid(dev, kernels, g) -> dict:
    """``affected_hubs`` for a seeded batch of 4 mutations on the
    road-mid graph: the endpoint planes' wall, their sweeps (one launch
    of a relaxation kernel a sweep) and the affected count; one endpoint
    plane is held against scipy's Dijkstra. Cut: no re-plant at this n
    (no full index of it fits the script's budget)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.dynamic import (affected_hubs, endpoint_planes,
                                     random_mutations)
    batch = random_mutations(g, np.random.default_rng(18), inserts=1,
                             deletes=2, reweights=1)
    t0 = time.perf_counter()
    rb = batch.resolve(g)
    g_new = batch.apply(g)
    host_s = time.perf_counter() - t0
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    affected = affected_hubs(g, g_new, rb, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k.name: k.launches for k in kernels}
    sweeps = counts["ell_relax"] + counts["ell_relax_windowed"]
    r = int(rb.u[0])
    plane = endpoint_planes(g, [r], device=dev)[r]
    A = sp.csr_matrix((g.weights.astype(np.float64), g.indices, g.indptr),
                      shape=(g.n, g.n))
    require(np.array_equal(plane, dijkstra(A, indices=r).astype(np.float32)),
            "frontier: endpoint plane != scipy Dijkstra")
    log(f"frontier road-mid n={g.n}: {batch.counts} on "
        f"{len(batch.touched())} endpoints: endpoint planes + tied-path "
        f"test {wall:.3f} s ({sweeps} sweeps: ell_relax "
        f"{counts['ell_relax']}, ell_relax_windowed "
        f"{counts['ell_relax_windowed']}), host resolve + apply "
        f"{host_s:.2f} s; affected {len(affected)} of {g.n} "
        f"({len(affected) / g.n * 100:.2f} %); an endpoint plane == scipy "
        "Dijkstra. Cut: no re-plant at this n (no full index of "
        f"{g.n} vertices fits the script's budget)")
    require(sweeps > 0, f"frontier: no relaxation launch {counts}")
    return {"launches": counts, "wall": wall, "affected": len(affected)}

def _scipy_csr(g):
    import numpy as np
    import scipy.sparse as sp
    return sp.csr_matrix((g.weights.astype(np.float64), g.indices,
                          g.indptr), shape=(g.n, g.n))


def phase_directed_exactness(dev, kernels) -> dict:
    """A full directed build on the card (``algo="directed"``: PLaNT on
    G and on its reverse a batch): SERVE_Q served pairs equal scipy's
    Dijkstra on the digraph; save -> load gives equal ``L_out``/``L_in``;
    a run stopped by a soft crash at its second ``engine.commit`` and
    resumed equals the uninterrupted tables."""
    import shutil
    import numpy as np
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import run_build
    from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
    from repro_torch.graphs import degree_ranking, random_connected
    from repro_torch.index import BuildPlan, CHLIndex, build
    g = random_connected(DIRECTED_EXACT_N, extra_edges=2 * DIRECTED_EXACT_N,
                         seed=7, directed=True)
    rank = degree_ranking(g)
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build(g, rank, BuildPlan(algo="directed", batch=EXACT_BATCH),
                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rng = np.random.default_rng(19)
    u = rng.integers(0, g.n, SERVE_Q)
    v = rng.integers(0, g.n, SERVE_Q)
    srv = idx.serve(mode="qlsn", batch_size=SERVE_Q)
    srv.submit(u, v)
    served = srv.flush()
    counts = path_launches(kernels, ("ell_relax", "label_query"),
                           "directed exactness")
    t1 = time.perf_counter()
    src = np.unique(u)
    want = dijkstra(_scipy_csr(g), indices=src)[np.searchsorted(src, u),
                                                 v].astype(np.float32)
    oracle_s = time.perf_counter() - t1
    require(np.array_equal(served, want),
            "directed exactness: served != Dijkstra")
    back = idx.query(v, u)
    asym = int((back != served).sum())
    require(asym > 0, "directed exactness: d(u->v) == d(v->u) everywhere")
    d, hub = idx.query_with_hub(u, v)
    require(np.array_equal(d, served) and bool((hub >= 0).all()),
            "directed exactness: query_with_hub != served, or a pair "
            "without a hub")
    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        loaded = CHLIndex.load(idx.save(os.path.join(tmp, "index")),
                               rank=rank, device=dev)
    require(loaded.directed and same_table(loaded.l_out, idx.l_out)
            and same_table(loaded.l_in, idx.l_in),
            "directed exactness: loaded tables != built")
    sweeps = sum(r.sweeps for r in idx.report.supersteps)
    regrows = [e.to_dict() for e in idx.report.overflow_events]
    log(f"directed exactness n={g.n} m={g.m}: build {wall:.3f} s, "
        f"{len(idx.report.supersteps)} supersteps, {sweeps} sweeps (the "
        f"larger direction's a batch), {idx.total_labels} labels (ALS "
        f"{idx.als:.2f} a direction, cap {idx.report.cap}, overflow events "
        f"{regrows}); {SERVE_Q} "
        f"served pairs == scipy Dijkstra on the digraph ({oracle_s:.1f} "
        f"s; {asym} pairs differ from their reverse); save->load tables "
        f"equal; launches {counts}")

    ckdir = scratch / "directed_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    reset(kernels)
    fplan = FaultPlan({"engine.commit": [Fault("crash", after=1)]})
    mgr = CheckpointManager(str(ckdir), keep=1)
    try:
        with faults(fplan):
            run_build(g, rank, algo="directed", batch=EXACT_BATCH,
                      cap=idx.report.cap, device=dev, ckpt=mgr)
        raise AssertionError("directed resume: the run was not stopped")
    except InjectedCrash as e:
        require(e.site == "engine.commit",
                f"directed resume: crashed at {e.site}")
    mgr.wait()                 # the first commit's save, still in flight
    require(mgr.all_steps() == [EXACT_BATCH],
            f"directed resume: committed steps {mgr.all_steps()}")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_build(g, rank, algo="directed", batch=EXACT_BATCH,
                    cap=idx.report.cap, device=dev,
                    ckpt=CheckpointManager(str(ckdir), keep=1), resume=True)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t1
    resume_counts = path_launches(kernels, ("ell_relax",),
                                  "directed resume")
    require(res.resumed_from == EXACT_BATCH,
            f"directed resume: resumed from {res.resumed_from}")
    require(same_table(res.sink.table("out"), idx.l_out)
            and same_table(res.sink.table("in"), idx.l_in),
            "directed resume: tables != the uninterrupted build's")
    shutil.rmtree(ckdir, ignore_errors=True)
    log(f"directed resume: a soft crash at the second engine.commit, "
        f"resumed from root cursor {res.resumed_from} in {resume_s:.2f} s "
        f"(a checkpoint of {g.n * idx.report.cap * 16:,} B of tables a "
        f"commit, at the build's cap); out and in tables == the uninterrupted "
        f"build's (torch.equal); launches {resume_counts}")
    return {"launches": {k: counts[k] + resume_counts[k] for k in counts},
            "wall": wall, "resume_s": resume_s}


def phase_sharded_exactness(dev, kernels, exact, repair) -> dict:
    """``build(store="sharded", shards=4)`` on phase 3's graph (PLaNT
    streamed into the shards) equals ``ShardedStore.from_table`` of phase
    3's dense table; save, then load as sharded, as dense and re-sharded
    to K = 3, each equal to its re-homing; ``apply`` of the repair
    phase's low-load batch on a sharded index equals the dense repair's
    table re-homed to 4 shards."""
    import numpy as np
    import torch
    from repro_torch.index import BuildPlan, CHLIndex, build
    from repro_torch.index.store import ShardedStore
    from repro_torch.kernels.label_query import KERNEL
    g, rank = exact["graph"]
    u, v, want = exact["queries"]
    plan = BuildPlan(algo="plant", batch=EXACT_BATCH, store="sharded",
                     shards=EXACT_SHARDS)
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build(g, rank, plan, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rehomed = ShardedStore.from_table(exact["table"], rank, EXACT_SHARDS)
    require(same_stores(idx.store, rehomed), "sharded exactness: streamed "
            "shards != phase 3's table re-homed")
    batch = 1024                             # queries a routed flush
    srv = idx.serve(mode="qlsn", batch_size=batch)
    before = KERNEL.launches
    srv.submit(u, v)
    served = srv.flush()
    routed_launches = KERNEL.launches - before
    u_d = torch.as_tensor(u, device=dev)
    v_d = torch.as_tensor(v, device=dev)
    before = KERNEL.launches
    d, h = idx.store.query_device(u_d, v_d)
    stacked_launches = KERNEL.launches - before
    counts = path_launches(kernels, ("ell_relax", "label_query"),
                           "sharded exactness")
    batches = -(-len(u) // batch)
    require(0 < routed_launches <= EXACT_SHARDS * batches,
            f"sharded exactness: {routed_launches} launches for "
            f"{batches} routed flushes of {EXACT_SHARDS} shards")
    require(stacked_launches == EXACT_SHARDS,
            f"sharded exactness: {stacked_launches} launches a stacked "
            f"query")
    require(np.array_equal(served, want),
            "sharded exactness: routed serve != Dijkstra")
    moved = check_stacked(idx.store, exact["table"], u_d, v_d, d, h,
                          "sharded exactness")
    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        path = idx.save(os.path.join(tmp, "index"))
        as_sharded = CHLIndex.load(path, rank=rank, device=dev)
        as_dense = CHLIndex.load(path, store="dense", device=dev)
        as_three = CHLIndex.load(path, store="sharded", shards=3, device=dev)
    merged = idx.table
    require(same_stores(as_sharded.store, idx.store),
            "sharded exactness: loaded shards != built")
    require(same_table(as_dense.table, merged),
            "sharded exactness: dense load != the merged shards")
    require(same_stores(as_three.store,
                        ShardedStore.from_table(merged, rank, 3)),
            "sharded exactness: K = 3 load != the re-sharded table")
    for what, other in (("dense", as_dense), ("K=3", as_three)):
        require(np.array_equal(other.query(u, v), want),
                f"sharded exactness: {what} load's answers != Dijkstra")
    low = repair["low-load"]
    g0 = low["graph"]
    rep_idx = build(g0, rank, plan, device=dev)
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = rep_idx.apply(low["batch"], graph=g0)
    torch.cuda.synchronize()
    repair_s = time.perf_counter() - t0
    rep_counts = path_launches(kernels, ("ell_relax",), "sharded repair")
    require(rep.store == "sharded" and same_stores(
        rep_idx.store, ShardedStore.from_table(low["table"], rank,
                                               EXACT_SHARDS)),
            "sharded repair: shards != the dense repair's table re-homed")
    log(f"sharded exactness n={g.n} K={EXACT_SHARDS}: streamed build "
        f"{wall:.3f} s (PLaNT dense {exact['wall']:.3f} s), "
        f"{idx.total_labels} labels in shards of "
        f"{[int(c) for c in idx.store.count.sum(dim=1).tolist()]}; == "
        f"phase 3's table re-homed; routed serve == Dijkstra "
        f"({routed_launches} launches in {batches} flushes), stacked "
        f"({stacked_launches} launches) "
        f"dist == dense, hubs == the plain stacked rule and real "
        f"witnesses ({moved} of {len(u)} differ from the dense store's "
        f"first-slot hub on a tie); save -> load sharded / dense / K=3 each "
        f"equal; repair of the low-load batch: affected {rep.affected}, "
        f"{repair_s:.3f} s, shards == the dense repair re-homed; "
        f"launches {counts} + repair {rep_counts}")
    return {"launches": {k: counts[k] + rep_counts[k] for k in counts},
            "wall": wall}


def check_stacked(store, table, u, v, d, h, what) -> int:
    """A sharded store's stacked answers ``(d, h)`` on the card against
    the plain version of the same rule (the plain query per shard, then
    the least distance over the shards, the lowest shard on a tie, as
    the reference's argmin) and against the dense table: equal
    distances, and every hub a real witness (in both rows, at the
    answer's distance). Returns how many hubs differ from the dense
    store's, which takes the first attaining slot of the merged row
    instead: the two rules part only where several hubs attain the
    minimum. Its dense query launches the kernel: call it after the
    path's launches are read."""
    import torch
    from repro_torch.index.store import DenseStore
    parts = [query_pairs_in_chunks(store.shard_table(k), u, v)
             for k in range(store.num_shards)]
    best, k = torch.min(torch.stack([p[0] for p in parts]), dim=0)
    hub = torch.gather(torch.stack([p[1] for p in parts]), 0, k[None])[0]
    hub = torch.where(torch.isfinite(best), hub, -1)
    require(torch.equal(d, best) and torch.equal(h, hub),
            f"{what}: stacked (dist, hub) != its plain version")
    dd, dh = DenseStore(table).query_device(u, v)
    require(torch.equal(d, dd), f"{what}: stacked dist != dense")

    def at(ids):
        rows = table.hubs[ids] == h[:, None]
        return torch.where(rows, table.dist[ids], torch.inf).amin(dim=1)

    fin = torch.isfinite(d)
    require(torch.equal((at(u) + at(v))[fin], d[fin])
            and bool((h[~fin] == -1).all()),
            f"{what}: a stacked hub is not a witness")
    return int((h != dh).sum())


def same_stores(a, b) -> bool:
    """Shard by shard, hubs, dist and count equal."""
    import numpy as np
    sa, sb = list(a.shard_arrays()), list(b.shard_arrays())
    return len(sa) == len(sb) and all(
        np.array_equal(x[key], y[key]) for (_, x), (_, y) in zip(sa, sb)
        for key in ("hubs", "dist", "count"))


def phase_sharded_road(dev, kernels, g, rank, road) -> dict:
    """Phase 5's first batch of road roots (ROAD_BATCH of its ROAD_TREES:
    a cut in depth; same batch and graph) streamed into ROAD_SHARDS hub
    shards through ``StreamingShardSink``: the shards equal
    ``hub_partition_arrays`` of phase 5's dense table restricted to
    those roots; a ``ShardedStore`` on the card answers phase 5's
    SERVE_Q pairs stacked (K launches and one cross-shard minimum: dist
    and hub) and routed, each equal to that dense table's store. Logs
    the host insert time, the accumulator's bytes and the stacked
    query's device time beside ``query_table``'s on the same pairs."""
    import numpy as np
    import torch
    from repro_torch.engine import PlantPolicy, StreamingShardSink, run
    from repro_torch.index.store import DenseStore, ShardedStore
    from repro_torch.kernels.label_query import KERNEL
    from repro_torch.parallel import hub_partition_arrays
    from repro_torch.serve import RoutedAnswer

    class TimedSink(StreamingShardSink):
        insert_s = 0.0

        def insert(self, *a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().insert(*a, **kw)
            self.insert_s += time.perf_counter() - t0

    reset(kernels)
    policy = PlantPolicy(g, rank, batch=ROAD_BATCH, device=dev,
                         roots_order=road["roots"][:ROAD_BATCH])
    sink = TimedSink(g.n, rank, ROAD_SHARDS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(policy, sink)
    wall = time.perf_counter() - t0
    acc = sink.acc
    acc_bytes = sum(a.nbytes for a in acc.hubs + acc.dist) + acc.count.nbytes
    del policy
    t1 = time.perf_counter()
    store = ShardedStore.from_accumulator(acc, device=dev)
    adopt_s = time.perf_counter() - t1
    table = first_trees_table(road["table"], road["roots"], ROAD_BATCH)
    t1 = time.perf_counter()
    want = hub_partition_arrays(table.hubs.cpu().numpy(),
                                table.dist.cpu().numpy(), rank, ROAD_SHARDS)
    part_s = time.perf_counter() - t1
    require(all(np.array_equal(x.cpu().numpy(), y) for x, y in
                zip((store.hubs, store.dist, store.count), want)),
            "sharded road: streamed shards != hub_partition_arrays of "
            "phase 5's table of the same roots")
    per_shard = [int(x) for x in store.count.sum(dim=1).tolist()]
    widest = [int(x) for x in store.count.max(dim=1).values.tolist()]
    insert_s, commits = sink.insert_s, len(res.records)
    del sink, acc, want
    u = torch.as_tensor(road["u"], device=dev)
    v = torch.as_tensor(road["v"], device=dev)
    before = KERNEL.launches
    d, h = store.query_device(u, v)
    stacked_launches = KERNEL.launches - before
    routed = RoutedAnswer(store)
    before = KERNEL.launches
    rd = routed(road["u"], road["v"])
    routed_launches = KERNEL.launches - before
    counts = path_launches(kernels, ("ell_relax_windowed", "label_query"),
                           "sharded road")
    require(stacked_launches == ROAD_SHARDS,
            f"sharded road: {stacked_launches} launches a stacked query")
    require(0 < routed_launches <= ROAD_SHARDS,
            f"sharded road: {routed_launches} launches a routed query")
    moved = check_stacked(store, table, u, v, d, h, "sharded road")
    dense = DenseStore(table)
    dd, _ = dense.query_device(u, v)
    require(torch.equal(rd, dd), "sharded road: routed != dense")
    sweeps = sum(r.sweeps for r in res.records)
    stacked = label_query_device_ms(lambda: store.query_device(u, v), 50)
    single = label_query_device_ms(lambda: dense.query_device(u, v), 50)
    stacked_ev = time_ms(lambda: store.query_device(u, v), reps=50)
    single_ev = time_ms(lambda: dense.query_device(u, v), reps=50)
    routed_ev = time_ms(lambda: routed(road["u"], road["v"]), reps=10)
    plain_ms = time_ms(lambda: [query_pairs_in_chunks(store.shard_table(k),
                                                      u, v)
                                for k in range(ROAD_SHARDS)],
                       reps=3, warmup=1)
    bnd, design = stacked_bound_ms(store, u, v)
    log(f"sharded road n={g.n} K={ROAD_SHARDS}: streamed superstep of "
        f"{ROAD_BATCH} roots {wall:.2f} s ({sweeps} sweeps; phase 5's "
        f"dense superstep of {ROAD_TREES} {road['wall']:.2f} s), host "
        f"insert {insert_s:.2f} s for "
        f"{commits} commits (planes fetched once a commit), "
        f"accumulator {acc_bytes:,} B on the host; ShardedStore on the card "
        f"{adopt_s:.2f} s, labels per shard {per_shard}, widest row per "
        f"shard {widest}; shards == hub_partition_arrays of phase 5's "
        f"table of these roots ({part_s:.1f} s); stacked and routed dist "
        f"== dense, "
        f"stacked hubs == the plain stacked rule and real witnesses "
        f"({moved} of {SERVE_Q} differ from the dense store's first-slot "
        f"hub on a tie); stacked {stacked_launches} launches, routed "
        f"{routed_launches}; launches {counts}")
    log(f"sharded road query ({SERVE_Q} pairs): stacked {ROAD_SHARDS} "
        f"launches, kernels {fmt_ms(stacked[0])} + reduction = "
        f"{fmt_ms(stacked[1])} device a call, events {stacked_ev:.4f} ms; "
        f"query_table one launch {fmt_ms(single[0])} device, events "
        f"{single_ev:.4f} ms; routed {routed_ev:.4f} ms (host routing "
        f"table, K subsets); plain per shard {plain_ms:.4f} ms; bound of "
        f"the function {bnd[0]:.4f} ms ({bnd[1]}), of the stacked design "
        f"(ids re-read a launch, K partials written and read back) "
        f"{design[0]:.4f} ms ({design[1]})")
    return {"launches": counts, "store": store, "stacked": {
        "device_ms": stacked[0], "device_ms_all": stacked[1],
        "ms": stacked_ev, "plain_ms": plain_ms, "bound_ms": bnd[0],
        "bound_by": bnd[1], "design_bound_ms": design[0],
        "launches_per_call": stacked_launches,
        "routed_launches_per_call": routed_launches,
        "query_table_device_ms": single[0], "routed_ms": routed_ev,
        "insert_s": insert_s, "accumulator_bytes": acc_bytes}}


# ------------------------------------------------ spill and compressed

def write_v1_artifact(directory, table, rank, idx) -> None:
    """A version-1 artifact in the reference's layout: one
    ``arrays.npz`` (rank, hubs, dist, count) and a version-1 manifest."""
    import numpy as np
    from repro_torch.index.artifact import rank_hash
    os.makedirs(directory)
    np.savez(os.path.join(directory, "arrays.npz"), rank=rank,
             hubs=table.hubs.cpu().numpy(), dist=table.dist.cpu().numpy(),
             count=table.count.cpu().numpy())
    manifest = {"format": "repro.index/chl", "version": 1,
                "plan": idx.plan.to_dict(), "report": idx.report.to_dict(),
                "rank_hash": rank_hash(rank), "directed": False,
                "n": idx.n, "total_labels": idx.total_labels,
                "als": idx.als}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def reduce_plain(parts):
    """The cross-shard rule of the spill and compressed stores over
    per-shard (dist, hub) pairs: the least distance, the lowest shard on
    a tie (a strict ``<`` fold, as the reference's)."""
    import torch
    best = torch.full_like(parts[0][0], torch.inf)
    hub = torch.full_like(parts[0][1], -1)
    for d, h in parts:
        take = d < best
        hub = torch.where(take, h, hub)
        best = torch.where(take, d, best)
    return best, hub


def compressed_plain(store, u, v):
    """A compressed store's answers by its plain version on the same
    device: each shard's rows gathered and decoded as the store does,
    intersected by ``label_query_ref`` in chunks, then `reduce_plain`."""
    import torch
    from repro_torch.kernels.label_query import label_query_ref
    parts = []
    for k in range(store.num_shards):
        hu, du = store.decode_rows(k, u)
        hv, dv = store.decode_rows(k, v)
        step = max(1, 2 ** 26 // max(1, hu.shape[1] ** 2))
        ch = [label_query_ref(hu[i:i + step], du[i:i + step],
                              hv[i:i + step], dv[i:i + step])
              for i in range(0, u.shape[0], step)]
        parts.append((torch.cat([c[0] for c in ch]),
                      torch.cat([c[1] for c in ch])))
    return reduce_plain(parts)


def witness_ok(table, u, v, d, h) -> bool:
    """Every hub is a real witness: both rows hold it at distances that
    sum to the answer; ``-1`` exactly where the answer is not finite."""
    import torch

    def at(ids):
        rows = table.hubs[ids] == h[:, None]
        return torch.where(rows, table.dist[ids], torch.inf).amin(dim=1)

    fin = torch.isfinite(d)
    return bool(torch.equal((at(u) + at(v))[fin], d[fin])
                and (h[~fin] == -1).all())


def card_ulp(store, ref) -> int:
    """The max f32 ulp error of ``store``'s distances against ``ref``'s,
    decoded on the card slot by slot (both stores encode one partition,
    so their sorted rows align): the device decoders' own reading of
    the lossy codec's error."""
    import torch
    worst = 0
    for k in range(store.num_shards):
        ids = torch.arange(store.n, device=store.device)
        _, a = store.decode_rows(k, ids)
        _, b = ref.decode_rows(k, ids)
        ok = torch.isfinite(b)
        if ok.any():
            diff = (a[ok].view(torch.int32).to(torch.int64)
                    - b[ok].view(torch.int32).to(torch.int64)).abs()
            worst = max(worst, int(diff.max()))
    return worst


def phase_spill_compressed_exactness(dev, kernels, exact) -> dict:
    """The spill and compressed stores on phase 3's graph (n = 4096).

    ``build(store="compressed", codec="u16", quant_exact=True, shards=4)``
    streams PLaNT into the shards and encodes them; SERVE_Q served pairs
    (16 Dijkstra sources x every target) equal scipy's Dijkstra, the
    stacked answers (dist and hub) equal the plain version's on CPU
    copies of the same store, and every hub is a real witness. A bf16
    re-encoding's ``max_ulp_err`` equals the one computed from CPU copies
    and the ulp error its codes show decoded on the card. The compressed
    artifact loads compressed (codec kept) and dense with the dense
    build's label sets; the dense and a sharded artifact load
    memory-mapped (``store="spill"``) and serve, routed
    and unrouted, equal to the dense store; an injected ``spill.query``
    fault quarantines a shard and ``health()`` names it; a version-1
    artifact loads dense and spilled, a version-2 manifest loads; and
    ``repro_torch.launch.serve_chl.main`` serves the saved compressed
    artifact."""
    import shutil
    import numpy as np
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core import labels as lbl
    from repro_torch.ft import Fault, FaultPlan, faults
    from repro_torch.index import BuildPlan, CHLIndex, build
    from repro_torch.index.store import CompressedStore, SpillStore
    from repro_torch.kernels.label_query import KERNEL
    from repro_torch.launch import serve_chl
    from repro_torch.serve import (QueryService, RoutedAnswer,
                                   ShardUnavailableError)
    g, rank = exact["graph"]
    table, dense = exact["table"], exact["index"]
    rng = np.random.default_rng(23)
    src = np.sort(rng.choice(g.n, SERVE_Q // g.n, replace=False))
    D = dijkstra(_scipy_csr(g), indices=src).astype(np.float32)
    perm = rng.permutation(SERVE_Q)
    u = np.repeat(src, g.n)[perm]
    v = np.tile(np.arange(g.n), len(src))[perm]
    want = D.reshape(-1)[perm]
    u_d = torch.as_tensor(u, device=dev)
    v_d = torch.as_tensor(v, device=dev)

    plan = BuildPlan(algo="plant", batch=EXACT_BATCH, store="compressed",
                     codec="u16", quant_exact=True, shards=EXACT_SHARDS)
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build(g, rank, plan, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    store = idx.store
    require(isinstance(store, CompressedStore) and store.exact
            and store.device.type == "cuda",
            "compressed exactness: not an exact compressed store on the card")
    srv = idx.serve(mode="qlsn", batch_size=SERVE_Q)
    before = KERNEL.launches
    srv.submit(u, v)
    served = srv.flush()
    routed_launches = KERNEL.launches - before
    before = KERNEL.launches
    d, h = store.query_device(u_d, v_d)
    stacked_launches = KERNEL.launches - before
    counts = path_launches(kernels, ("ell_relax", "label_query"),
                           "compressed exactness")
    require(0 < routed_launches <= EXACT_SHARDS
            and stacked_launches == EXACT_SHARDS,
            f"compressed exactness: {routed_launches} routed, "
            f"{stacked_launches} stacked launches")
    require(np.array_equal(served, want),
            "compressed exactness: served != Dijkstra")
    require(np.array_equal(d.cpu().numpy(), want),
            "compressed exactness: stacked dist != Dijkstra")
    t1 = time.perf_counter()
    cpu_copy = CompressedStore.from_encoded_shards(
        [dict(a) for _, a in store.shard_arrays()], store.manifest_info(),
        rank, device="cpu")
    pd, ph = cpu_copy.query_device(u, v)
    plain_s = time.perf_counter() - t1
    require(torch.equal(d.cpu(), pd) and torch.equal(h.cpu(), ph),
            "compressed exactness: card (dist, hub) != the plain version's "
            "on CPU copies")
    require(witness_ok(table, u_d, v_d, d, h),
            "compressed exactness: a hub is not a witness")
    _, dh = dense.store.query_device(u_d, v_d)
    moved = int((h != dh).sum())

    bf = CompressedStore.from_store(store, rank, codec="bf16")
    bf_cpu = CompressedStore.from_store(cpu_copy, rank, codec="bf16")
    ulp = card_ulp(bf, store)
    require(ulp == bf.max_ulp_err == bf_cpu.max_ulp_err,
            f"bf16: card ulp {ulp}, max_ulp_err {bf.max_ulp_err} (card "
            f"store) and {bf_cpu.max_ulp_err} (CPU copy) differ")
    got = bf.query(u, v)[0]
    tol = 2 * np.float32(2.0 ** -8) * np.maximum(want, 1.0)
    require(bool((np.abs(got - want) <= tol).all()),
            "bf16: an answer outside the codec's documented bound")

    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    sets = lbl.to_numpy_sets(table)
    dd, _ = dense.store.query_device(u_d, v_d)
    dd = dd.cpu().numpy()
    reset(kernels)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        cpath = idx.save(os.path.join(tmp, "comp"))
        as_comp = CHLIndex.load(cpath, rank=rank, device=dev)
        require(isinstance(as_comp.store, CompressedStore)
                and as_comp.store.codec == "u16"
                and lbl.to_numpy_sets(as_comp.table) == sets,
                "compressed load: codec or label sets differ")
        as_dense = CHLIndex.load(cpath, store="dense", device=dev)
        require(lbl.to_numpy_sets(as_dense.table) == sets,
                "compressed load as dense: label sets != the dense build's")
        dpath = dense.save(os.path.join(tmp, "dense"))
        spath = CHLIndex.load(cpath, store="sharded",
                              device=dev).save(os.path.join(tmp, "sharded"))
        spilled = {}
        for what, p in (("dense", dpath), ("sharded", spath)):
            sp_idx = CHLIndex.load(p, store="spill", device=dev)
            require(isinstance(sp_idx.store, SpillStore)
                    and sp_idx.store.is_mapped(),
                    f"spill {what}: labels not memory-mapped")
            for routed in (None, False):
                s = sp_idx.serve(mode="qlsn", batch_size=SERVE_Q,
                                 routed=routed)
                s.submit(u, v)
                require(np.array_equal(s.flush(), dd),
                        f"spill {what} (routed={routed}) != dense")
            spilled[what] = sp_idx
        spill_counts = path_launches(kernels, ("label_query",),
                                     "spill exactness")
        ra = RoutedAnswer(spilled["sharded"].store)
        w = int(np.nonzero(ra._has[0])[0][0])
        with faults(FaultPlan({"spill.query": [Fault("io")]})):
            try:
                ra(w, w)
                raise AssertionError("spill fault: no quarantine")
            except ShardUnavailableError:
                pass
        svc = QueryService(ra, batch_size=4, drop_first=False)
        svc.submit([w], [w])
        svc.drain()
        health = svc.health()
        require(health["status"] == "degraded"
                and 0 in health["quarantined_shards"],
                f"spill fault: health {health}")
        v1 = os.path.join(tmp, "v1")
        write_v1_artifact(v1, table, rank, dense)
        v1_dense = CHLIndex.load(v1, rank=rank, device=dev)
        require(same_table(v1_dense.table, table), "v1: dense table differs")
        v1_spill = CHLIndex.load(v1, store="spill", device=dev)
        require(v1_spill.store.is_mapped()
                and np.array_equal(v1_spill.query(u, v), dd),
                "v1: spilled answers != dense")
        v2 = os.path.join(tmp, "v2")
        shutil.copytree(dpath, v2)
        with open(os.path.join(v2, "manifest.json")) as f:
            manifest = json.load(f)
        manifest["version"] = 2
        with open(os.path.join(v2, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        require(same_table(CHLIndex.load(v2, device=dev).table, table),
                "v2: dense table differs")
        t1 = time.perf_counter()
        out = serve_chl.main(["--index", cpath, "--queries", "4096",
                              "--batch-size", "1024", "--seed", "3"])
        entry_s = time.perf_counter() - t1
        erng = np.random.default_rng(3)
        eu = erng.integers(0, g.n, 4096).astype(np.int32)
        ev = erng.integers(0, g.n, 4096).astype(np.int32)
        require(out["index"].store.kind == "compressed"
                and np.array_equal(out["distances"], dense.query(eu, ev)),
                "serve_chl: distances != the dense index's")
    log(f"compressed exactness n={g.n} K={EXACT_SHARDS}: u16-exact build "
        f"{wall:.3f} s (PLaNT dense {exact['wall']:.3f} s), "
        f"{store.label_bytes():,} B of labels ({store.dtypes()}) against "
        f"{store.total_labels * 8:,} B dense; {SERVE_Q} served pairs "
        f"({len(src)} Dijkstra sources x every target, largest "
        f"{float(D[np.isfinite(D)].max()):.0f}) == Dijkstra "
        f"({routed_launches} routed launches), stacked "
        f"({stacked_launches} launches) dist and "
        f"hub == the plain version on CPU copies ({plain_s:.2f} s), hubs "
        f"real witnesses ({moved} differ from the dense store's on ties); "
        f"bf16 lossy max_ulp_err {bf.max_ulp_err} == the CPU copy's and its "
        f"card decode's; "
        f"compressed artifact loads compressed and dense with the dense "
        f"build's label sets; launches {counts}")
    log(f"spill exactness: dense and K={EXACT_SHARDS} artifacts mapped, "
        f"served routed and unrouted == dense; spill.query io fault "
        f"quarantined shard 0 ({health['quarantined_shards'][0][:40]}...); "
        f"v1 dense and spilled, v2 loads; serve_chl.main on the "
        f"compressed artifact {entry_s:.2f} s, distances == dense; "
        f"launches {spill_counts}")
    return {"launches": {k: counts[k] + spill_counts[k] for k in counts},
            "wall": wall}


def label_query_device_ms(fn, reps, top=0):
    """(device ms a call of the label_query kernels alone, of all the
    call's device work) from one profiler window; None where the window
    holds no such event. With ``top``, also the ``top`` device events
    by total time: (name, ms a call, launches a call)."""
    evs = device_events(fn, reps)
    lq = [e for e in evs if DEVICE_NAMES["label_query"] in e.name]
    out = (covered(lq) / 1e3 / reps if lq else None,
           covered(evs) / 1e3 / reps if evs else None)
    if not top:
        return out
    by_name = {}
    for e in evs:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + (e.time_range.end - e.time_range.start)
                           / 1e3 / reps, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return out + ([(name[:60], ms, n / reps) for name, (ms, n) in ranked],)


def phase_spill_compressed_road(dev, kernels, rank, road, sharded) -> dict:
    """The road state's K = 4 hub shards (phase 5c's ``ShardedStore``,
    its partition kept) encoded and spilled at full size.

    ``CompressedStore.from_store(codec="u32", exact=True)``: on phase 5's
    SERVE_Q pairs the distances equal the stacked sharded answer and the
    hubs the plain version's (decoded rows through ``label_query_ref``
    on the card); ``u16`` exact raises ``QuantRangeError``; bf16 lossy
    logs its ``max_ulp_err``. The sharded store is saved and loaded
    ``store="spill"`` (checksums verified); its routed answer equals the
    stacked one. Logs the encode wall, label bytes against the sharded
    store's, the query's device time against the stacked query's, and
    the spill query split into host gather, copy and kernel."""
    import numpy as np
    import torch
    from repro_torch.index import (BuildPlan, BuildReport, CHLIndex,
                                   QuantRangeError)
    from repro_torch.index.store import CompressedStore
    from repro_torch.kernels.label_query import KERNEL, query_rows
    from repro_torch.serve import RoutedAnswer
    store = sharded["store"]
    u_np, v_np = road["u"], road["v"]
    u = torch.as_tensor(u_np, device=dev)
    v = torch.as_tensor(v_np, device=dev)
    sd, sh = store.query_device(u, v)
    t0 = time.perf_counter()
    comp = CompressedStore.from_store(store, rank, codec="u32", exact=True)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    reset(kernels)
    cd, ch = comp.query_device(u, v)
    counts = path_launches(kernels, ("label_query",), "compressed road")
    require(counts["label_query"] == ROAD_SHARDS,
            f"compressed road: {counts['label_query']} launches a query")
    require(torch.equal(cd, sd),
            "compressed road: u32-exact dist != the stacked sharded answer")
    pd, ph = compressed_plain(comp, u, v)
    require(torch.equal(cd, pd) and torch.equal(ch, ph),
            "compressed road: (dist, hub) != the plain version's")
    require(witness_ok(road["table"], u, v, cd, ch),
            "compressed road: a hub is not a witness")
    moved = int((ch != sh).sum())
    t0 = time.perf_counter()
    try:
        CompressedStore.from_store(store, rank, codec="u16", exact=True)
        raise AssertionError("compressed road: u16 exact was not refused")
    except QuantRangeError as e:
        refusal = str(e).split(" at scale")[0]
    refuse_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bf = CompressedStore.from_store(store, rank, codec="bf16")
    bf_s = time.perf_counter() - t0
    bf_ulp = bf.max_ulp_err
    bf_bytes = bf.label_bytes()
    del bf
    comp_dev = label_query_device_ms(lambda: comp.query_device(u, v), 20,
                                     top=4)
    stacked_dev = label_query_device_ms(lambda: store.query_device(u, v), 20)
    comp_ms = time_ms(lambda: comp.query_device(u, v), reps=20)
    stacked_ms = time_ms(lambda: store.query_device(u, v), reps=20)
    comp_bytes, sharded_bytes = comp.label_bytes(), store.label_bytes()
    dtypes = comp.dtypes()
    del comp, pd, ph

    scratch = ROOT / "build"                 # git-ignored, in the checkout
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        idx = CHLIndex(store, plan=BuildPlan(algo="plant", batch=ROAD_BATCH,
                                             cap=ROAD_CAP, store="sharded",
                                             shards=ROAD_SHARDS),
                       report=BuildReport(algo="plant", wall_s=0.0,
                                          cap=ROAD_CAP,
                                          total_labels=store.total_labels,
                                          als=store.total_labels / store.n),
                       rank=rank)
        t0 = time.perf_counter()
        path = idx.save(os.path.join(tmp, "road"))
        save_s = time.perf_counter() - t0
        size = sum(os.path.getsize(os.path.join(path, f))
                   for f in os.listdir(path))
        t0 = time.perf_counter()
        spill = CHLIndex.load(path, store="spill", device=dev)
        load_s = time.perf_counter() - t0
        require(spill.store.is_mapped(), "spill road: labels not mapped")
        routed = RoutedAnswer(spill.store)
        reset(kernels)
        t0 = time.perf_counter()
        rd = routed(u_np, v_np)
        torch.cuda.synchronize()
        routed_s = time.perf_counter() - t0
        spill_counts = path_launches(kernels, ("label_query",), "spill road")
        require(torch.equal(rd, sd), "spill road: routed != stacked")
        # the unrouted query's parts, shard by shard
        gather_s = copy_s = 0.0
        rows = []
        for k in range(ROAD_SHARDS):
            t0 = time.perf_counter()
            host = spill.store.gather_rows(k, u_np, v_np)
            gather_s += time.perf_counter() - t0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rows.append([torch.from_numpy(a).to(dev) for a in host])
            torch.cuda.synchronize()
            copy_s += time.perf_counter() - t0
        kern = label_query_device_ms(
            lambda: [query_rows(*r) for r in rows], 20)
        sp_d, _ = spill.store.query_device(u_np, v_np)
        require(torch.equal(sp_d, sd), "spill road: stacked != sharded")
        row_bytes = sum(a.element_size() * a.numel() for r in rows for a in r)
        del rows, spill, routed, idx
    log(f"compressed road n={store.n} K={ROAD_SHARDS}: u32-exact encode "
        f"{encode_s:.2f} s ({dtypes}), {comp_bytes:,} B of labels against "
        f"the sharded store's {sharded_bytes:,} B "
        f"({sharded_bytes / max(1, comp_bytes):.3f}x); {SERVE_Q} pairs: "
        f"dist == stacked sharded, (dist, hub) == the plain version, hubs "
        f"real witnesses ({moved} differ from the sharded store's); "
        f"query device {fmt_ms(comp_dev[0])} kernels / {fmt_ms(comp_dev[1])} "
        f"all (events {comp_ms:.4f} ms) against stacked "
        f"{fmt_ms(stacked_dev[0])} / {fmt_ms(stacked_dev[1])} (events "
        f"{stacked_ms:.4f} ms); its top device work a call "
        f"{[(n, round(ms, 4), k) for n, ms, k in comp_dev[2]]}; u16 exact "
        f"refused in {refuse_s:.2f} s "
        f"({refusal}); bf16 lossy encode {bf_s:.2f} s, {bf_bytes:,} B, "
        f"max_ulp_err {bf_ulp}; launches {counts}")
    log(f"spill road: save {save_s:.2f} s ({size:,} B on disk), load "
        f"spill with checksums {load_s:.2f} s, routed {routed_s * 1e3:.1f} "
        f"ms == stacked ({spill_counts['label_query']} launches); unrouted "
        f"{ROAD_SHARDS} shards: host gather {gather_s * 1e3:.2f} ms, copy "
        f"{copy_s * 1e3:.2f} ms ({row_bytes:,} B), kernels "
        f"{fmt_ms(kern[0])} device")
    return {"launches": {k: counts[k] + spill_counts[k] for k in counts},
            "compressed": {"encode_s": encode_s, "label_bytes": comp_bytes,
                           "sharded_bytes": sharded_bytes,
                           "device_ms": comp_dev[0],
                           "device_ms_all": comp_dev[1], "ms": comp_ms,
                           "stacked_device_ms_all": stacked_dev[1],
                           "bf16_max_ulp_err": bf_ulp},
            "spill": {"save_s": save_s, "load_s": load_s, "bytes": size,
                      "routed_ms": routed_s * 1e3,
                      "gather_ms": gather_s * 1e3, "copy_ms": copy_s * 1e3,
                      "kernel_device_ms": kern[0]}}


# ------------------------------------------------------------ distributed

def dijkstra_pairs(g, seed, sources=None):
    """SERVE_Q pairs: ``sources`` (default SERVE_Q // n random ones) x
    every target, shuffled, with scipy's Dijkstra distances."""
    import numpy as np
    from scipy.sparse.csgraph import dijkstra
    rng = np.random.default_rng(seed)
    src = (np.sort(rng.choice(g.n, SERVE_Q // g.n, replace=False))
           if sources is None else np.asarray(sources))
    D = dijkstra(_scipy_csr(g), indices=src).astype(np.float32)
    perm = rng.permutation(len(src) * g.n)
    u = np.repeat(src, g.n)[perm]
    v = np.tile(np.arange(g.n), len(src))[perm]
    return u, v, D.reshape(-1)[perm]


def same_sets(table, want) -> bool:
    from repro_torch.core import labels as lbl
    return lbl.to_numpy_sets(table) == want


def superstep_calls(records, calls, what) -> str:
    """Require no collective call in a PLaNT superstep and at least one
    in a DGLL superstep; returns ``mode:calls`` a superstep."""
    require(len(records) == len(calls),
            f"{what}: {len(calls)} call counts for {len(records)} records")
    for r, c in zip(records, calls):
        if r.mode in ("plant", "plant-hc"):
            require(c == 0, f"{what}: a {r.mode} superstep made {c} "
                    "collective calls")
        else:
            require(c > 0, f"{what}: a {r.mode} superstep made no "
                    "collective call")
    return " ".join(f"{r.mode}:{c}" for r, c in zip(records, calls))


def serve_modes(idx, mesh, u, v, want, what) -> dict:
    """qlsn, qfdl and qdol through ``serve`` (one flush each), each equal
    to ``want``; returns each mode's flush wall and launches."""
    import numpy as np
    import torch
    from repro_torch.kernels.label_query import KERNEL
    out = {}
    for mode in ("qlsn", "qfdl", "qdol"):
        srv = idx.serve(mode=mode, mesh=mesh, batch_size=len(u))
        before = KERNEL.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.submit(u, v)
        got = srv.flush()
        torch.cuda.synchronize()
        out[mode] = (time.perf_counter() - t0, KERNEL.launches - before)
        require(np.array_equal(got, want), f"{what}: {mode} answers "
                "differ")
    return out


def phase_distributed_exactness(dev, kernels, exact) -> dict:
    """The distributed family on phase 3's graph (n = 4096).

    ``build(g, rank)`` with the default plan (the hybrid: eta = 16, auto
    Ψ) on the card's one-node mesh; then the hybrid (eta = 16, Ψ_th
    below 1, chl_common's compact budget), dgll and plant-dist on an
    8-node logical mesh on the card, each merged table equal to phase
    3's PLaNT table as label sets, no collective call in a PLaNT
    superstep and at least one in a DGLL superstep; qlsn, qfdl and qdol
    of the 8-node hybrid answer SERVE_Q Dijkstra pairs exactly;
    plant-dist with node 1 silent after superstep 2 and a heartbeat
    monitor of patience 1 re-plants node 1's tail on the survivors and
    lands the same label sets. Then the 8-node hybrid on the card equals
    the CPU's, partitions, merged table and records, on
    grid_road(DIST_SMALL_SIDE, DIST_SMALL_SIDE)."""
    import numpy as np
    import torch
    from repro_torch.configs.chl_common import ChlConfig
    from repro_torch.core.dgll import merge_partitions, stack_partitions
    from repro_torch.core.hybrid import run_distributed
    from repro_torch.engine import run_build
    from repro_torch.ft import HeartbeatMonitor
    from repro_torch.graphs import betweenness_ranking, grid_road
    from repro_torch.index import BuildPlan, BuildReport, CHLIndex, build
    from repro_torch.index.store import DenseStore
    from repro_torch.parallel import NodeMesh
    from repro_torch.parallel import collectives as coll
    from repro_torch.core import labels as lbl
    g, rank = exact["graph"]
    want = lbl.to_numpy_sets(exact["table"])
    u, v, dists = dijkstra_pairs(g, 29)
    compact = ChlConfig.__dataclass_fields__["compact"].default
    walls, launches = {}, {k.name: 0 for k in kernels}

    def add(counts):
        for name, c in counts.items():
            launches[name] += c

    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx = build(g, rank, device=dev)
    torch.cuda.synchronize()
    walls["default"] = time.perf_counter() - t0
    rep = idx.report
    require(idx.plan == BuildPlan() and rep.algo == "hybrid" and rep.q == 1,
            "distributed exactness: the default build is not a one-node "
            "hybrid")
    require(same_sets(idx.table, want), "distributed exactness: the "
            "default build's label sets != phase 3's PLaNT table")
    add(path_launches(kernels, ("ell_relax",), "default hybrid"))
    log(f"distributed exactness: build(g, rank) (hybrid, eta "
        f"{idx.plan.eta}, Ψ_th {rep.psi_threshold}, one node): "
        f"{walls['default']:.3f} s, supersteps "
        f"{[(r.mode, r.trees) for r in rep.supersteps]}, "
        f"{idx.total_labels} labels == phase 3's label sets")

    mesh = NodeMesh.logical(DIST_Q, dev)
    plans = {"hybrid": dict(eta=16, psi_threshold=DIST_PSI_LOW,
                            compact=compact),
             "dgll": {}, "plant-dist": {}}
    hybrid = None
    for algo, kw in plans.items():
        reset(kernels)
        coll.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_build(g, rank, algo=algo, batch=idx.plan.batch,
                        mesh=mesh, **kw)
        merged = merge_partitions(res.sink.tables)
        torch.cuda.synchronize()
        walls[algo] = time.perf_counter() - t0
        require(same_sets(merged, want), f"distributed exactness: {algo} "
                "label sets != phase 3's PLaNT table")
        calls = superstep_calls(res.records, res.extras["collective_calls"],
                                f"{algo} x{DIST_Q}")
        add(path_launches(kernels, ("ell_relax",), f"{algo} x{DIST_Q}"))
        log(f"distributed exactness: {algo} on {DIST_Q} logical nodes: "
            f"{walls[algo]:.3f} s, collectives {dict(coll.COUNTS)} moving "
            f"{dict(coll.BYTES)} B, supersteps (mode:calls) {calls}, "
            f"comm_label_slots {res.counters['comm_label_slots']}; label "
            "sets == phase 3's")
        if algo == "hybrid":
            hybrid = res, merged
    res, merged = hybrid
    total = int(merged.count.sum())
    report = BuildReport(algo="hybrid", wall_s=walls["hybrid"],
                         total_labels=total, als=total / g.n,
                         cap=res.sink.cap, supersteps=list(res.records),
                         q=DIST_Q)
    hidx = CHLIndex(DenseStore(merged), plan=BuildPlan(batch=idx.plan.batch),
                    report=report, rank=rank,
                    partitioned=res.extras["partitioned"])
    reset(kernels)
    served = serve_modes(hidx, mesh, u, v, dists, "distributed exactness")
    add(path_launches(kernels, ("label_query",), "query modes"))
    log(f"distributed exactness: {len(u)} Dijkstra pairs through "
        "serve(qlsn | qfdl | qdol) on the 8-node hybrid: " + ", ".join(
            f"{m} {w:.3f} s in {c} launches" for m, (w, c) in served.items())
        + " ; all == Dijkstra")

    reset(kernels)
    mon = HeartbeatMonitor(DIST_Q, patience=1)
    t0 = time.perf_counter()
    merged, stats = run_distributed(g, rank, mesh=mesh,
                                    batch=idx.plan.batch, beta=2.0, eta=0,
                                    psi_threshold=float("inf"),
                                    algo_name="plant-dist", monitor=mon,
                                    silent_after={1: 2})
    torch.cuda.synchronize()
    walls["elastic"] = time.perf_counter() - t0
    require(stats["dead_nodes"] == [1] and stats["replanted_trees"] > 0,
            f"elastic: dead {stats['dead_nodes']}, replanted "
            f"{stats['replanted_trees']}")
    require(same_sets(merged, want), "elastic: label sets != phase 3's")
    add(path_launches(kernels, ("ell_relax",), "elastic"))
    log(f"distributed exactness: plant-dist x{DIST_Q}, node 1 silent after "
        f"superstep 2: lost, {stats['replanted_trees']} trees "
        f"({stats['replanted_labels']} labels) re-planted on the "
        f"survivors in {walls['elastic']:.3f} s; label sets == phase 3's")

    gs = grid_road(DIST_SMALL_SIDE, DIST_SMALL_SIDE, seed=7)
    rs = betweenness_ranking(gs, samples=12)
    plan = BuildPlan(eta=16, psi_th=DIST_PSI_LOW, compact=compact)
    reset(kernels)
    card = build(gs, rs, plan, mesh=NodeMesh.logical(DIST_Q, dev))
    add(path_launches(kernels, ("ell_relax",), "small hybrid"))
    t0 = time.perf_counter()
    cpu = build(gs, rs, plan, mesh=NodeMesh.logical(DIST_Q, "cpu"))
    cpu_wall = time.perf_counter() - t0
    for a, b in zip(stack_partitions(card.partitioned),
                    stack_partitions(cpu.partitioned)):
        require(torch.equal(a.cpu(), b), "distributed: card partitions != "
                "the CPU's")
    require(same_table([x.cpu() for x in card.table], cpu.table)
            and card.report.supersteps == cpu.report.supersteps,
            "distributed: card merged table or records != the CPU's")
    log(f"distributed exactness: the 8-node hybrid on grid_road("
        f"{DIST_SMALL_SIDE}, {DIST_SMALL_SIDE}) on the card == the CPU's "
        f"(partitions {tuple(stack_partitions(card.partitioned).hubs.shape)}"
        f", merged table, records {[r.mode for r in card.report.supersteps]};"
        f" CPU {cpu_wall:.2f} s, card {card.report.wall_s:.2f} s); "
        f"launches {launches}")
    return {"launches": launches, "walls": walls}


def phase_distributed_road(dev, kernels, g, rank, known) -> dict:
    """The hybrid on chl_road (n = 16,777,216, width 8, batch 4, cap 8,
    hc_cap 32, compact 4096) on ROAD_NODES logical nodes of the card:
    eta = ROAD_ETA common trees (the prologue), one HC-pruned PLaNT
    superstep of a batch of 4 trees a node and one DGLL superstep of 3
    (the queues cut to ROAD_DIST_COLS columns a node). Checks that the
    node steps swept through the windowed kernel only, that no
    collective ran in a PLaNT superstep and one did in the DGLL
    superstep, and that for SERVE_Q pairs (r, v), r a processed root
    (the top ranks, so the answers are exact), qlsn = qfdl = qdol, all
    finite, and equal scipy's Dijkstra from two of the roots (``known``:
    phase 5's Dijkstra row of the top root, and one more). Logs the
    common table, prologue and superstep walls, the fallback, the
    collectives' calls and bytes and a profiled window of HC-pruned
    sweeps."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import dijkstra
    from repro_torch.core.dgll import merge_partitions
    from repro_torch.engine import MeshTableSink, run
    from repro_torch.engine.dist import DistributedPolicy
    from repro_torch.index import BuildPlan, BuildReport, CHLIndex
    from repro_torch.index.store import DenseStore
    from repro_torch.kernels.ell_relax import layout_plan
    from repro_torch.parallel import NodeMesh
    from repro_torch.core.plant import hc_block_fn
    from repro_torch.parallel import collectives as coll
    plan_w = layout_plan(g.n, dev, bb=ROAD.batch)
    require(plan_w.num_windows > 1, "distributed road: planes fit one "
            "window")
    mesh = NodeMesh.logical(ROAD_NODES, dev)
    policy = DistributedPolicy(
        g, rank, mesh=mesh, batch=ROAD.batch, beta=2.0,
        first_superstep=ROAD.batch, cap=ROAD.cap, eta=ROAD_ETA,
        hc_cap=ROAD.hc_cap, psi_threshold=DIST_PSI_LOW,
        compact=ROAD.compact, mode_name="hybrid")
    policy.queues = policy.queues[:, :ROAD_DIST_COLS]
    walls = {}

    def timed(name, fn):
        def wrapper(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
            return out
        return wrapper
    policy.begin = timed("common table", policy.begin)
    policy.prologue = timed("prologue", policy.prologue)
    policy.step = timed("superstep", policy.step)
    reset(kernels)
    coll.reset_counts()
    t0 = time.perf_counter()
    res = run(policy, MeshTableSink(mesh, g.n, ROAD.cap))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(kernels, ("ell_relax_windowed",),
                             "distributed road")
    require(launches["ell_relax"] == 0, "distributed road: a node step "
            "took the dense sweep")
    modes = [r.mode for r in res.records]
    require(modes[:2] == ["plant-hc", "plant"] and len(modes) == 3
            and modes[2].startswith("dgll"),
            f"distributed road: supersteps {modes}")
    calls = superstep_calls(res.records, res.extras["collective_calls"],
                            "distributed road")
    log(f"distributed road: {ROAD_NODES} nodes, {g.n} vertices, "
        f"{plan_w.num_windows} source windows: wall {wall:.2f} s = common "
        f"table {walls['common table'][0]:.2f} s + prologue "
        f"{walls['prologue'][0]:.2f} s + supersteps "
        f"{[round(w, 2) for w in walls['superstep']]} s; records "
        f"{[(r.mode, r.trees, r.labels, round(r.psi, 3)) for r in res.records]}"
        f"; collectives (mode:calls) {calls}, {dict(coll.COUNTS)} moving "
        f"{dict(coll.BYTES)} B (each node's piece to the other), "
        f"comm_label_slots {res.counters['comm_label_slots']}; launches "
        f"{launches}")

    t1 = time.perf_counter()
    merged = merge_partitions(res.sink.tables)
    torch.cuda.synchronize()
    total = int(merged.count.sum())
    report = BuildReport(algo="hybrid", wall_s=wall, total_labels=total,
                         als=total / g.n, cap=ROAD.cap,
                         supersteps=list(res.records), q=ROAD_NODES)
    idx = CHLIndex(DenseStore(merged), plan=BuildPlan(batch=ROAD.batch),
                   report=report, rank=rank,
                   partitioned=res.extras["partitioned"])
    merge_s = time.perf_counter() - t1
    roots = policy.queues.reshape(-1)
    roots = roots[roots >= 0]
    rng = np.random.default_rng(31)
    u = rng.choice(roots, SERVE_Q)
    v = rng.integers(0, g.n, SERVE_Q)
    qlsn = idx.query(u, v)
    require(bool(np.isfinite(qlsn).all()), "distributed road: a pair of "
            "a processed root has no common hub")
    t1 = time.perf_counter()
    plain, _ = query_pairs_in_chunks(
        merged, torch.as_tensor(u, device=dev).long(),
        torch.as_tensor(v, device=dev).long())
    require(np.array_equal(plain.cpu().numpy(), qlsn), "distributed road: "
            "qlsn on the merged table != the plain query")
    plain_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    served = serve_modes(idx, mesh, u, v, qlsn, "distributed road")
    serve_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    top, d_top = known
    other = int(roots[roots != top][0])
    rows = {int(top): d_top.astype(np.float32),
            other: dijkstra(_scipy_csr(g), indices=other).astype(np.float32)}
    sources = np.array(list(rows))
    checked = 0
    for r, D in rows.items():
        sel = u == r
        require(np.array_equal(qlsn[sel], D[v[sel]]),
                f"distributed road: answers from root {r} != Dijkstra")
        checked += int(sel.sum())
    log(f"distributed road: {total} labels merged in {merge_s:.2f} s; "
        f"{SERVE_Q} pairs from the {len(roots)} processed roots: qlsn on "
        f"the merged [{g.n}, {merged.cap}] table == the plain query "
        f"({plain_s:.2f} s) == qfdl == qdol (" + ", ".join(
            f"{m} {w:.3f} s in {c} launches" for m, (w, c) in served.items())
        + f", modes {serve_s:.1f} s with the qdol store built on the host),"
        f" all finite; {checked} of them from roots {sources.tolist()} == "
        f"scipy Dijkstra ({time.perf_counter() - t1:.1f} s)")
    hc = policy.hc[0]
    first = policy.queues[0, 1:1 + ROAD.batch]      # superstep 1, node 0
    del idx, merged, res, policy
    torch.cuda.empty_cache()
    trace_sweeps(dev, "road hc-pruned", g, rank, first, ROAD.batch,
                 block=lambda r: hc_block_fn(hc, r))
    return {"launches": launches, "wall": wall, "walls": walls}


def directed_graph():
    from repro_torch.graphs import degree_ranking, random_connected
    t0 = time.perf_counter()
    g = random_connected(RANDOM_N, extra_edges=RANDOM_EXTRA, seed=0,
                         directed=True)
    rank = degree_ranking(g)
    log(f"directed graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s (two from_edges)")
    return g, rank


def phase_directed_scale(dev, kernels, g, rank) -> dict:
    """The chl-scalefree configuration on a digraph: one cluster node's
    RANDOM_TREES top-ranked roots through ``DirectedPlantPolicy`` (each
    batch PLaNTed on G into ``L_in`` and on its reverse into ``L_out``,
    both through the source-windowed sweep), then SERVE_Q queries
    ``(h, v)`` and ``(v, h)`` for planted roots h, which the top roots'
    labels answer exactly, served through ``serve(mode="qlsn")`` (one
    two-table launch a flush), checked against scipy's Dijkstra from
    two roots on G and on its transpose, and against the plain query."""
    import numpy as np
    import torch
    from scipy.sparse.csgraph import dijkstra
    import repro_torch.engine.policies as policies
    from repro_torch.core import labels as lbl
    from repro_torch.engine import (BatchSchedule, DenseSink,
                                    DirectedPlantPolicy, rank_order, run)
    from repro_torch.index import BuildPlan, BuildReport, CHLIndex
    from repro_torch.kernels.ell_relax import layout_plan
    from repro_torch.kernels.label_query import KERNEL, label_query_ref

    roots = rank_order(rank)[:RANDOM_TREES]
    require(layout_plan(g.n, dev, bb=RANDOM_BATCH).num_windows > 1,
            "directed scale: planes fit one window")
    t0 = time.perf_counter()
    policy = DirectedPlantPolicy(g, rank, batch=RANDOM_BATCH, device=dev)
    policy.schedule = lambda: BatchSchedule(roots, RANDOM_BATCH)
    setup_s = time.perf_counter() - t0
    sweeps = []
    plant = policies.plant_batch

    def counted(*a, **kw):
        tb = plant(*a, **kw)
        sweeps.append(tb.sweeps)
        return tb

    reset(kernels)
    policies.plant_batch = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run(policy, DenseSink(g.n, RANDOM_CAP, dev,
                                    channels=("out", "in")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        policies.plant_batch = plant
    del policy
    l_out, l_in = res.sink.table("out"), res.sink.table("in")
    total = lbl.total_labels(l_out) + lbl.total_labels(l_in)
    idx = CHLIndex(l_out=l_out, l_in=l_in,
                   plan=BuildPlan(algo="directed", batch=RANDOM_BATCH,
                                  cap=RANDOM_CAP),
                   report=BuildReport(algo="directed", wall_s=wall,
                                      total_labels=total,
                                      als=total / (2 * g.n), cap=RANDOM_CAP,
                                      supersteps=list(res.records)),
                   rank=rank)
    rng = np.random.default_rng(23)
    half = SERVE_Q // 2
    hs = roots[rng.integers(0, RANDOM_TREES, SERVE_Q)]
    xs = rng.integers(0, g.n, SERVE_Q)
    u = np.concatenate([hs[:half], xs[half:]])
    v = np.concatenate([xs[:half], hs[half:]])
    srv = idx.serve(mode="qlsn", batch_size=SERVE_Q)
    before = KERNEL.launches
    t0 = time.perf_counter()
    srv.submit(u, v)
    served = srv.flush()
    serve_s = time.perf_counter() - t0
    flush_launches = KERNEL.launches - before
    require(flush_launches == 1, f"directed scale: {flush_launches} "
            "label_query launches for one flush")
    counts = path_launches(kernels, ("ell_relax_windowed", "label_query"),
                           "directed scale")
    require(counts["ell_relax"] == 0, "directed scale: the dense sweep ran")
    require(bool(np.isfinite(served).all()),
            "directed scale: a planted root's pair is unanswered")
    ud = torch.as_tensor(u, device=dev)
    vd = torch.as_tensor(v, device=dev)
    pd, _ = label_query_ref(l_out.hubs[ud], l_out.dist[ud], l_in.hubs[vd],
                            l_in.dist[vd])
    require(np.array_equal(served, pd.cpu().numpy()),
            "directed scale: served != plain query")
    t0 = time.perf_counter()
    A = _scipy_csr(g)
    At = A.T.tocsr()
    checked = 0
    for r in roots[:2]:
        fwd = dijkstra(A, indices=int(r)).astype(np.float32)     # d(r->x)
        bwd = dijkstra(At, indices=int(r)).astype(np.float32)    # d(x->r)
        sel = np.flatnonzero(u[:half] == r)
        require(np.array_equal(served[sel], fwd[v[sel]]),
                f"directed scale: d({r}->v) != Dijkstra on G")
        sel2 = half + np.flatnonzero(v[half:] == r)
        require(np.array_equal(served[sel2], bwd[u[sel2]]),
                f"directed scale: d(u->{r}) != Dijkstra on the transpose")
        checked += len(sel) + len(sel2)
    oracle_s = time.perf_counter() - t0
    fwd_sweeps, bwd_sweeps = sweeps[0::2], sweeps[1::2]
    log(f"directed scale n={g.n}: set-up of the policy {setup_s:.1f} s "
        f"(the reverse's from_edges, device arrays, two windowed layouts); "
        f"{len(res.records)} supersteps x {RANDOM_BATCH} trees, sweeps on "
        f"G {fwd_sweeps} and on the reverse {bwd_sweeps} (records "
        f"{[r.sweeps for r in res.records]}), {total} labels, wall "
        f"{wall:.2f} s (the undirected random superstep: see phase 6); "
        f"launches {counts}")
    log(f"directed scale serve: {SERVE_Q} queries (h, v) and (v, h) for "
        f"planted h in one flush, {flush_launches} label_query launch, "
        f"host wall {serve_s:.3f} s; == plain query; {checked} of them == "
        f"scipy Dijkstra from 2 roots on G and its transpose "
        f"({oracle_s:.1f} s)")
    return {"launches": counts, "wall": wall, "sweeps": sweeps,
            "l_out": l_out, "l_in": l_in, "u": ud, "v": vd}


def time_query_pair(dev, what, l_out, l_in, u, v, reps=100) -> dict:
    """The two-table form (a directed query: ``L_out[u]`` against
    ``L_in[v]``) on one state, as `time_query_table` times the table
    form: held equal to the plain version, then device, event and host
    times, the plain version's ms and the bound from this run's
    counts."""
    import torch
    from repro_torch.kernels.label_query import (KERNEL,
                                                 label_query_pair_rows,
                                                 label_query_ref)
    call = lambda: label_query_pair_rows(l_out, l_in, u, v)  # noqa: E731
    plain = lambda: label_query_ref(l_out.hubs[u], l_out.dist[u],  # noqa
                                    l_in.hubs[v], l_in.dist[v])
    kd, kh = call()
    pd, ph = plain()
    torch.cuda.synchronize()
    require(torch.equal(kd, pd) and torch.equal(kh, ph),
            f"label_query_pair_rows != plain at the {what} state")
    err = max_abs_err(kd, pd)
    before = KERNEL.launches
    evs = device_events(call, reps)
    launches = (KERNEL.launches - before - 1) / reps
    lq = [e for e in evs if DEVICE_NAMES["label_query"] in e.name]
    dms = covered(lq) / 1e3 / len(lq) if lq else None
    ms = time_ms(call, reps=reps)
    hus = host_us(call, reps)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    cu = l_out.count[u].double()
    cv = l_in.count[v].double()
    Q = u.shape[0]
    bnd = bound(Q * (16 + 8 + 8) + 8 * float((cu + cv).sum()),
                float((cu * cv).sum()))
    log(f"time label_query (two-table form) at the {what} state (n="
        f"{l_out.n}, L={l_out.cap}, Q={Q}): device {fmt_ms(dms)} per call "
        f"in {launches:g} launch, events {ms:.4f} ms, host {hus:.1f} us, "
        f"plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})")
    require(launches == 1, f"two-table form: {launches} launches a call")
    return {"device_ms": dms, "ms": ms, "host_us": hus, "plain_ms": plain_ms,
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "launches_per_call": launches, "max_abs_err": err}


def time_relax(dev, what, g, rank, roots, batch, sweeps, reps=20) -> dict:
    """The relaxation kernels, and their plain versions, on one mid-build
    state (``sweeps`` sweeps from the top roots, all trees live, dense
    prop): the dense ``ell_relax`` always, ``ell_relax_windowed`` too
    where the card's L2 calls for windows, on the same state."""
    import torch
    from repro_torch.graphs import device_arrays
    from repro_torch.kernels.ell_relax import (ell_relax, ell_relax_windowed,
                                               ell_sweep_bucketed_plain,
                                               ell_sweep_plain)
    from repro_torch.sssp import batched_sssp_maxrank, ell_layout
    a = device_arrays(g, rank, dev)
    lay = ell_layout(a.ell_src, a.ell_w, batch=batch)
    roots_d = torch.as_tensor(roots[:batch], device=dev).long()
    st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots_d,
                              max_sweeps=sweeps, layout=lay)
    B, n = st.dist.shape
    deg = a.ell_src.shape[1]
    E = int(torch.isfinite(a.ell_w).sum())
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    planes = (st.dist, st.mrank, st.dist, alive)
    runs = {"ell_relax": (
        lambda: ell_relax(*planes, a.ell_src, a.ell_w, a.rank),
        lambda: ell_sweep_plain(*planes, a.ell_src, a.ell_w, a.rank))}
    geometry = "one window"
    if lay is not None:
        runs["ell_relax_windowed"] = (
            lambda: ell_relax_windowed(*planes, lay, a.rank),
            lambda: ell_sweep_bucketed_plain(*planes, lay, a.rank))
        segs = lay.segments
        geometry = f"{lay.num_windows} windows of {lay.window}"
        log(f"{what} layout: {geometry}, {segs.seg_row.numel()} segments "
            f"({segs.seg_row.numel() / n:.3f} per vertex), "
            f"{segs.bare_rows.numel()} vertices without a finite in-edge")
    bnd = relax_bound_ms(B, n, E, B)
    out, first = {}, None
    for name, (kern, plain) in runs.items():
        kd, km = kern()
        pd, pm = plain()
        torch.cuda.synchronize()
        require(torch.equal(kd, pd) and torch.equal(km, pm),
                f"{name} != plain at the {what} state")
        if first is None:
            first = (kd, km)
        require(torch.equal(kd, first[0]) and torch.equal(km, first[1]),
                f"{name} != ell_relax at the {what} state")
        err = max(max_abs_err(kd, pd), max_abs_err(km, pm))
        del pd, pm
        m = measure(name, kern, plain, reps=reps, plain_reps=3)
        out[name] = dict(m, max_abs_err=err, bound_ms=bnd[0],
                         bound_by=bnd[1])
        dms = m["device_ms"]
        log(f"time {name} at the {what} state B={B} n={n} ELL width {deg}"
            f", {E} finite in-edges ({E / n:.3f} per vertex), {geometry}:"
            f" kernel {m['ms']:.4f} ms per call (events), device "
            f"{fmt_ms(dms)}, host {m['host_us']:.1f} us per call, plain "
            f"{m['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
            f"{bnd[0] / (dms or m['ms']) * 100:.1f}% of the bound "
            "(device time)")
    return out


def trace_sweeps(dev, what, g, rank, roots, batch, sweeps=16,
                 block=None) -> None:
    """A profiler window (``torch.profiler``, CPU and CUDA) over
    ``sweeps`` steady sweeps of ``batched_sssp_maxrank`` from the top
    roots (``block(roots)``, when given, makes the sweeps' pruning
    mask), on the route the card's L2 picks: the device's busy share of
    the window, each kernel's device time by name, and per sweep the
    relaxation kernel's time, the sweep loop's own tensor ops' and the
    idle time. All times are the trace's device timestamps; without
    device events the lines say "not measured"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graphs import device_arrays
    from repro_torch.sssp import batched_sssp_maxrank, ell_layout
    a = device_arrays(g, rank, dev)
    lay = ell_layout(a.ell_src, a.ell_w, batch=batch)
    roots_d = torch.as_tensor(roots[:batch], device=dev).long()
    block_fn = None if block is None else block(roots_d)
    batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots_d,
                         max_sweeps=4, layout=lay,
                         block_fn=block_fn)                 # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots_d,
                                  max_sweeps=sweeps, layout=lay,
                                  block_fn=block_fn)
        torch.cuda.synchronize()
    kern = cuda_events(prof)
    if not kern:
        log(f"trace {what}: not measured (the profile holds no device "
            "time)")
        return

    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    busy = covered(kern)
    relax = covered([e for e in kern if "relax" in e.name])
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                      - e.time_range.start)
    n = st.sweeps
    log(f"trace {what}: {n} sweeps over {len(kern)} device kernels, "
        f"device span {span / 1e3:.3f} ms, busy {busy / span * 100:.1f} % "
        f"(idle {100 - busy / span * 100:.1f} %); per sweep "
        f"{span / n / 1e3:.4f} ms: relaxation kernel "
        f"{relax / n / 1e3:.4f} ms, the sweep loop's tensor ops "
        f"{(busy - relax) / n / 1e3:.4f} ms, idle "
        f"{(span - busy) / n / 1e3:.4f} ms")
    for name, t in sorted(by_name.items(), key=lambda x: -x[1])[:8]:
        short = name.replace("(anonymous namespace)::", "").replace(
            "void ", "").split("(")[0][:90]
        log(f"trace {what}:   {t / n / 1e3:.4f} ms per sweep  {short}")


def time_query_table(dev, what, table, u, v, reps=100) -> dict:
    """``query_table`` on one state: held equal to the plain query, then
    ``device_ms`` (from a profiler window over ``reps`` calls, which must
    hold no device work but the hand-written kernel; the mean of the
    launches it recorded, since a window late in a long run may drop
    some), ``ms`` (events per call), ``host_us``, the plain version's
    ms, the bound from this run's counts and the launches a call (from
    the kernel's count, which must be one)."""
    import torch
    from repro_torch.kernels.label_query import KERNEL, query_table
    call = lambda: query_table(table, u, v)             # noqa: E731
    plain = lambda: query_pairs_in_chunks(table, u, v)  # noqa: E731
    kd, kh = call()
    pd, ph = plain()
    torch.cuda.synchronize()
    require(torch.equal(kd, pd) and torch.equal(kh, ph),
            f"query_table != plain at the {what} state")
    err = max_abs_err(kd, pd)
    del pd, ph
    before = KERNEL.launches
    evs = device_events(call, reps)
    launches = (KERNEL.launches - before - 1) / reps     # after a warm-up
    names = sorted({e.name for e in evs})
    require(launches == 1 and len(evs) <= reps and all(
        DEVICE_NAMES["label_query"] in x for x in names),
            f"query_table at the {what} state: {launches} launches and "
            f"{len(evs)} device events a call ({names}); want one "
            "label_query launch and no other device work")
    dms = covered(evs) / 1e3 / len(evs) if evs else None
    ms = time_ms(call, reps=reps)
    hus = host_us(call, reps)
    plain_ms = time_ms(plain, reps=3, warmup=1)
    bnd = query_table_bound_ms(table, u, v)
    Q, L = u.shape[0], table.cap
    counts = torch.cat([table.count[u], table.count[v]]).float()
    log(f"time query_table at the {what} state (n={table.n}, L={L}, "
        f"Q={Q}, mean count {float(counts.mean()):.2f}): device "
        f"{fmt_ms(dms)} per call in {launches:g} launch and no other "
        f"device work ({len(evs)} of {reps} launches in the profile: "
        f"{', '.join(names) or 'none'}), events {ms:.4f} ms, host "
        f"{hus:.1f} us, plain {plain_ms:.4f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); {bnd[0] / (dms or ms) * 100:.1f}% of the bound")
    return {"device_ms": dms, "ms": ms, "host_us": hus,
            "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
            "launches_per_call": launches, "max_abs_err": err}


def time_label_operands(dev, table, u, v, reps=100) -> dict:
    """The operand form on the rows of (u, v), gathered once outside the
    timing: the kernel alone, without the row reads of the table form."""
    import torch
    from repro_torch.kernels.label_query import label_query, label_query_ref
    lops = (table.hubs[u], table.dist[u], table.hubs[v], table.dist[v])
    kd, kh = label_query(*lops)
    pd, ph = label_query_ref(*lops)
    torch.cuda.synchronize()
    require(torch.equal(kd, pd) and torch.equal(kh, ph),
            "label_query != plain at the road serving shape")
    Q, L = lops[0].shape
    m = measure("label_query", lambda: label_query(*lops),
                lambda: label_query_ref(*lops), reps=reps, plain_reps=20)
    bnd = label_query_bound_ms(Q, L)
    log(f"time label_query (operand form) Q={Q} L={L}: kernel "
        f"{m['ms']:.4f} ms per call (events), device "
        f"{fmt_ms(m['device_ms'])}, host {m['host_us']:.1f} us per call, "
        f"plain {m['plain_ms']:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
        f"{bnd[0] / (m['device_ms'] or m['ms']) * 100:.1f}% of the bound")
    return dict(m, max_abs_err=max_abs_err(kd, pd), bound_ms=bnd[0],
                bound_by=bnd[1])


def random_pairs(dev, n, seed):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, n, SERVE_Q), device=dev),
            torch.as_tensor(rng.integers(0, n, SERVE_Q), device=dev))


def phase_dense(dev, kernels) -> dict:
    """Dense-block PLaNT over the minplus kernel, held against the ELL
    engine on the card, then minplus timed at its shape."""
    import torch
    from repro_torch.engine import rank_order
    from repro_torch.graphs import device_arrays, degree_ranking, scale_free
    from repro_torch.kernels.minplus import (dense_weights, minplus,
                                             minplus_plain,
                                             plant_fixpoint_dense)
    mp = importlib.import_module("repro_torch.kernels.minplus.minplus")
    minplus_geometry = mp.launch_geometry
    from repro_torch.sssp import batched_sssp_maxrank
    t0 = time.perf_counter()
    g = scale_free(DENSE_N, attach=2, seed=0)
    rank = degree_ranking(g)
    roots = torch.as_tensor(rank_order(rank)[:DENSE_ROOTS], device=dev)
    a = device_arrays(g, rank, dev)
    log(f"dense graph n={g.n} m={g.m}: host set-up "
        f"{time.perf_counter() - t0:.1f} s")
    reset(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = dense_weights(g, dev)
    dist, mrank, emit = plant_fixpoint_dense(w, a.rank, roots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = path_launches(kernels, ("minplus",), "dense")
    st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots)
    require(torch.equal(dist, st.dist) and torch.equal(mrank, st.mrank),
            "dense: (dist, mrank) != the ELL engine's")
    want = (st.mrank == a.rank[roots][:, None]) & torch.isfinite(st.dist)
    require(torch.equal(emit, want), "dense: emit != the ELL emit rule")
    log(f"dense block: W [{g.n}, {g.n}] f32 ({w.numel() * 4 / 1e9:.2f} GB)"
        f", {DENSE_ROOTS} roots to fixpoint in {launches['minplus']} "
        f"sweeps, wall {wall:.3f} s (W built on the card included); "
        f"(dist, mrank) == batched_sssp_maxrank over the ELL, emit == "
        f"its rule ({int(emit.sum())} labels); launches {launches}")

    ops = (dist, mrank, w)
    kern = lambda: minplus(*ops)                        # noqa: E731
    ms = time_ms(kern, reps=5, warmup=1)
    dms = device_ms(kern, 3, "minplus")
    hus = host_us(kern, 5)
    kd, km = minplus(*ops)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pd, pm = minplus_plain(*ops)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    require(torch.equal(kd, pd) and torch.equal(km, pm),
            "minplus != plain at the dense block's shape")
    err = max(max_abs_err(kd, pd), max_abs_err(km, pm))
    del pd, pm
    B, K = dist.shape
    N = w.shape[1]
    bnd = minplus_bound_ms(B, K, N)
    gx, gy, blocks, waves = minplus_geometry(
        B, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    log(f"time minplus B={B} K={K} N={N} ({blocks} blocks of "
        f"{mp.TB} x {mp.TN}, {waves:.3f} waves at {mp.BLOCKS_PER_SM} blocks "
        f"per SM): kernel {ms:.4f} ms per "
        f"call (events), device {fmt_ms(dms)}, host {hus:.1f} us per "
        f"call, plain {plain_ms:.4f} ms (once), bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); {bnd[0] / (dms or ms) * 100:.1f}% of the bound")
    return {"launches": launches,
            "minplus": {"max_abs_err": err, "ms": ms, "device_ms": dms,
                        "host_us": hus, "plain_ms": plain_ms,
                        "bound_ms": bnd[0], "bound_by": bnd[1]}}


def road_graph():
    from repro_torch.graphs import degree_ranking, grid_road
    t0 = time.perf_counter()
    g = grid_road(ROAD_ROWS, ROAD_COLS)
    rank = degree_ranking(g)
    log(f"road graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s")
    return g, rank


def road_mid_graph():
    from repro_torch.graphs import degree_ranking, grid_road
    t0 = time.perf_counter()
    g = grid_road(MID_ROAD_SIDE, MID_ROAD_SIDE)
    rank = degree_ranking(g)
    log(f"road-mid graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s")
    return g, rank


def random_mid_graph():
    from repro_torch.graphs import degree_ranking, random_connected
    t0 = time.perf_counter()
    g = random_connected(MID_RANDOM_N, extra_edges=MID_RANDOM_N, seed=0)
    rank = degree_ranking(g)
    log(f"random-mid graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s")
    return g, rank


def random_graph():
    from repro_torch.graphs import degree_ranking, random_connected
    t0 = time.perf_counter()
    g = random_connected(RANDOM_N, extra_edges=RANDOM_EXTRA, seed=0)
    rank = degree_ranking(g)
    log(f"random graph n={g.n} m={g.m} ELL width {g.max_deg_in}: host "
        f"set-up {time.perf_counter() - t0:.1f} s")
    return g, rank


SOURCES = {
    "ell_relax": ("src/repro_torch/kernels/ell_relax/csrc/ell_relax.cu",
                  "src/repro/kernels/ell_relax/ell_relax.py:123"),
    "ell_relax_windowed": (
        "src/repro_torch/kernels/ell_relax/csrc/ell_relax_windowed.cu",
        "src/repro/kernels/ell_relax/ell_relax.py:131"),
    "label_query": (
        "src/repro_torch/kernels/label_query/csrc/label_query.cu",
        "src/repro/kernels/label_query/label_query.py:32"),
    "minplus": ("src/repro_torch/kernels/minplus/csrc/minplus.cu",
                "src/repro/kernels/minplus/minplus.py:36"),
}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    from repro_torch.engine import rank_order
    from repro_torch.kernels import all_kernels, build_all
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)} ({card}), L2 "
        f"{torch.cuda.get_device_properties(dev).L2_cache_size} B")

    t0 = time.perf_counter()
    kernels = build_all(all_kernels())
    log(f"kernel build (nvcc, sm_90a, in parallel): "
        f"{time.perf_counter() - t0:.2f} s")
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {k.name}: {line.strip()}")

    phase_parity(dev)
    launches = {k.name: 0 for k in kernels}

    def add(counts):
        for name, c in counts.items():
            launches[name] += c

    exact = phase_exactness(dev, kernels)
    add(exact["launches"])
    add(phase_shared_memory(dev, kernels, exact)["launches"])
    add(phase_crash_matrix(dev, kernels, exact)["launches"])
    repair = phase_repair(dev, kernels, exact)
    add(repair["launches"])
    add(phase_directed_exactness(dev, kernels)["launches"])
    add(phase_sharded_exactness(dev, kernels, exact, repair)["launches"])
    del repair
    add(phase_spill_compressed_exactness(dev, kernels, exact)["launches"])
    add(phase_distributed_exactness(dev, kernels, exact)["launches"])
    g, rank = exact["graph"]
    lq = {"exactness": time_query_table(
        dev, "exactness", exact["table"], *random_pairs(dev, g.n, 13))}
    table = synthetic_table(dev, SYNTH_N, SYNTH_L, SYNTH_POOL, seed=256)
    lq["synthetic_256"] = time_query_table(
        dev, f"synthetic L={SYNTH_L}", table,
        *random_pairs(dev, SYNTH_N, 17), reps=20)
    del table
    times = {"ell_relax": time_relax(dev, "exactness", g, rank,
                                     rank_order(rank), EXACT_BATCH,
                                     sweeps=32, reps=200)["ell_relax"]}
    trace_sweeps(dev, "exactness", g, rank, rank_order(rank), EXACT_BATCH,
                 sweeps=64)
    # the dense route at a realistic size: two mid-build states whose
    # planes just fit half the L2 (timing states, not build phases)
    mid = {}
    for what, make in (("road-mid", road_mid_graph),
                       ("random-mid", random_mid_graph)):
        g, rank = make()
        r = time_relax(dev, what, g, rank, rank_order(rank), ROAD_BATCH,
                       sweeps=MID_SWEEPS[what], reps=50)
        require(list(r) == ["ell_relax"], f"{what}: planes outgrow half "
                "the L2, so the state is not on the dense route")
        mid[what] = r["ell_relax"]
        if what == "road-mid":
            add(phase_frontier_mid(dev, kernels, g)["launches"])
        del g, rank

    dense = phase_dense(dev, kernels)
    add(dense["launches"])
    times["minplus"] = dense["minplus"]
    torch.cuda.empty_cache()

    g, rank = road_graph()
    road = phase_scale(dev, kernels, "road", g, rank, ROAD_BATCH,
                       ROAD_TREES, ROAD_CAP)
    add(road["launches"])
    add(phase_road_resume(dev, kernels, g, rank, road)["launches"])
    ru, rv = (torch.as_tensor(road[x], device=dev) for x in ("u", "v"))
    lq["road"] = time_query_table(dev, "road", road["table"], ru, rv)
    lq["operand_road"] = time_label_operands(dev, road["table"], ru, rv)
    del ru, rv
    road_relax = time_relax(dev, "road", g, rank, road["roots"],
                            ROAD_BATCH, sweeps=256)
    trace_sweeps(dev, "road", g, rank, road["roots"], ROAD_BATCH)
    torch.cuda.empty_cache()
    add(phase_gll_road(dev, kernels, g, rank, road)["launches"])
    torch.cuda.empty_cache()
    sharded_road = phase_sharded_road(dev, kernels, g, rank, road)
    add(sharded_road["launches"])
    lq["stacked_road"] = sharded_road["stacked"]
    stores = phase_spill_compressed_road(dev, kernels, rank, road,
                                         sharded_road)
    add(stores["launches"])
    lq["compressed_road"] = stores["compressed"]
    lq["spill_road"] = stores["spill"]
    known = road["dijkstra"]
    del road, sharded_road, stores
    torch.cuda.empty_cache()
    add(phase_distributed_road(dev, kernels, g, rank, known)["launches"])
    del known
    del g, rank
    torch.cuda.empty_cache()

    g, rank = random_graph()
    rnd = phase_scale(dev, kernels, "random", g, rank, RANDOM_BATCH,
                      RANDOM_TREES, RANDOM_CAP)
    add(rnd["launches"])
    lq["random"] = time_query_table(
        dev, "random", rnd["table"],
        *(torch.as_tensor(rnd[x], device=dev) for x in ("u", "v")))
    rnd_relax = time_relax(dev, "random", g, rank, rnd["roots"],
                           RANDOM_BATCH, sweeps=8)
    trace_sweeps(dev, "random", g, rank, rnd["roots"], RANDOM_BATCH)
    log(f"random superstep wall {rnd['wall']:.2f} s (beside the directed "
        "one below)")
    del g, rank, rnd
    torch.cuda.empty_cache()

    g, rank = directed_graph()
    drt = phase_directed_scale(dev, kernels, g, rank)
    add(drt["launches"])
    lq["pair_directed"] = time_query_pair(dev, "directed", drt["l_out"],
                                          drt["l_in"], drt["u"], drt["v"])
    del g, rank, drt
    torch.cuda.empty_cache()

    # the dense-vs-windowed comparison on the road and random states
    # rides along as extra fields
    times["ell_relax"].update(road_mid=mid["road-mid"],
                              random_mid=mid["random-mid"],
                              road=road_relax["ell_relax"],
                              random=rnd_relax["ell_relax"])
    times["ell_relax_windowed"] = dict(road_relax["ell_relax_windowed"],
                                       random=rnd_relax["ell_relax_windowed"])
    # query_table on the road state is the headline; the other states
    # and the operand form ride along
    times["label_query"] = dict(lq.pop("road"), **lq)
    headline = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    # device_ms and host_us of every kernel ride along beside the
    # headline keys
    records = [record(name, *SOURCES[name], launches[name],
                      t["max_abs_err"], t["ms"], t["plain_ms"],
                      (t["bound_ms"], t["bound_by"]),
                      **{k: v for k, v in t.items() if k not in headline})
               for name, t in ((k.name, times[k.name]) for k in kernels)]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
