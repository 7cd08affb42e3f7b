"""Traffic kind ``plant_cycles``: one node's first PLaNT supersteps,
repeated, in a closed loop with one batch in flight.

Mix parameters (the traffic file): ``trees`` (the roots a cycle commits:
the top ``trees`` of the rank order), ``sample_rows`` (rows of every
completed cycle's table compared), ``warm_sweeps`` (sweeps of the
set-up's warm-up).

Set-up: the configuration's generator makes the edge list from the
seed, its ranking ranks it, and the port builds the graph
(``graphs.from_edges``), moves it to the card and lays it out
(``engine.PlantPolicy``), then warms the sweep and the label insert on
the cell's own shapes. The window: each cycle starts from an empty
``DenseSink`` and commits the schedule's trees batch by batch through
the policy's ``step`` (what ``engine.run`` does for this policy), the
device synchronised after each batch. No batch starts that the longest
so far says would end past the window; the first cycle always
completes. After the window: the peak memory is read, the program's
state freed, and the reference checks the last completed cycle and the
partial one after it in full, and every completed cycle at the sampled
rows.
"""

from __future__ import annotations

import gc
import sys
import time
from types import SimpleNamespace

import numpy as np

from chlbench import bench, check, trace
from chlbench.counts import least_work


def inputs(bench_dir, cfg: dict, mix: dict, seed: int):
    """The cell's inputs from the seed: ``(n, src, dst, w, rank, roots,
    sample)``, the edge list, the ranking, the schedule's roots and the
    rows of each cycle that are compared. With the configuration's
    ``relabel``, the generated graph and its ranking are served under a
    vertex numbering the seed draws: the same problem in another order."""
    graph_ss, sample_ss = np.random.SeedSequence(seed % (1 << 64)).spawn(2)
    rng = np.random.default_rng(graph_ss)
    gen = bench.load_module(bench_dir / "graphs" / f"{cfg['generator']}.py")
    n, src, dst, w = gen.edges(cfg, rng)
    rank = bench.load_module(bench_dir / "rankings"
                             / f"{cfg['ranking']}.py").rank(n, src, dst)
    if cfg.get("relabel"):
        perm = rng.permutation(n).astype(np.int32)
        src, dst = perm[src], perm[dst]
        rank = rank[np.argsort(perm)]
    order = np.argsort(-rank.astype(np.int64), kind="stable")
    roots = order[:int(mix["trees"])]
    sample = np.sort(np.random.default_rng(sample_ss).choice(
        n, size=min(n, int(mix["sample_rows"])), replace=False))
    return n, src, dst, w, rank, roots, sample


def _rows(table, idx):
    return (table.hubs[idx], table.dist[idx], table.count[idx])


def run(ctx) -> SimpleNamespace:
    import torch
    from repro_torch.engine import (DenseSink, PlantPolicy, fetch_stat_rows,
                                    record_from_row)
    from repro_torch.graphs.graph import from_edges
    from repro_torch.kernels.ell_relax import clear_layout_cache
    from repro_torch.sssp.relax import batched_sssp_maxrank

    cfg, mix = ctx.config, ctx.traffic
    dev = torch.device(ctx.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    spans = trace.Spans()
    B, cap = int(cfg["batch"]), int(cfg["cap"])
    trees = int(mix["trees"])

    # ------------------------------------------------------------ set-up
    with spans("inputs"):
        n, src, dst, w, rank, roots, sample = inputs(ctx.bench, cfg, mix,
                                                     ctx.seed)
    with spans("graph_build"):
        g = from_edges(n, src, dst, w, directed=False)
    with spans("policy"):
        policy = PlantPolicy(g, rank, batch=B, device=dev,
                             roots_order=roots)
    steps = list(policy.schedule().steps())
    with spans("warm_up"):
        a = policy.arrays
        r = torch.as_tensor(steps[0].roots, device=dev)
        st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, r,
                                  max_sweeps=int(mix["warm_sweeps"]),
                                  layout=policy.layout)
        emit = (st.mrank == a.rank[r.long()][:, None]) \
            & torch.isfinite(st.dist)
        warm = DenseSink(n, cap, dev)
        warm.insert(r, emit, st.dist)
        del st, emit, warm
    idx = torch.as_tensor(sample, device=dev)
    sync()
    tracer = trace.DeviceTrace() if ctx.trace and cuda else None
    if tracer is not None:
        tracer.start()

    # ------------------------------------------------------------ window
    t_start = time.perf_counter()
    deadline = t_start + ctx.seconds
    t_end = t_start
    pending = []                    # per batch: the step's output
    cycles = []                     # per cycle: batches committed
    done = cur = None               # last completed sink, sink in flight
    first_rows, sampled = None, []  # device rows, per-cycle mismatches
    est_batch = 0.0

    def complete(sink):
        nonlocal done, first_rows
        rows = _rows(sink.table(), idx)
        if first_rows is None:
            first_rows = tuple(x.clone() for x in rows)
        else:
            sampled.append(check.rows_differing(*rows, *first_rows).sum())
        done = sink

    with spans("window"):
        stop = False
        while not stop:
            for s in steps:
                t = time.perf_counter()
                if done is not None and t + est_batch > deadline:
                    stop = True
                    break
                if cur is None:
                    with spans("new_sink"):
                        cur = DenseSink(n, cap, dev)
                    cycles.append(0)
                with spans("plant_step"):
                    out = policy.step(s, cur)
                    sync()
                t_end = time.perf_counter()
                est_batch = max(est_batch, t_end - t)
                pending.append(out)
                cycles[-1] += 1
            else:
                complete(cur)
                cur = None
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    if tracer is not None:
        tracer.stop()

    # ------------------------------------------------- after the window
    records = [record_from_row(o.mode, row, trees=o.trees) for o, row in
               zip(pending, fetch_stat_rows([o.stats for o in pending]))]
    overflow = sum(int(s.overflowed()) for s in (done, cur)
                   if s is not None)
    # (cycle, table, roots committed): the last completed cycle, and the
    # one in flight when the window closed
    tables = [(len(cycles) - 1 - (cur is not None), done.table(), trees)]
    if cur is not None:
        tables.append((len(cycles) - 1, cur.table(),
                       min(trees, cycles[-1] * B)))
    per_cycle = [int(x) for x in sampled]    # cycles 1.. against cycle 0
    policy = g = a = r = done = cur = out = pending = None
    clear_layout_cache()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    with spans("reference"):
        ref = bench.load_module(ctx.bench / "reference"
                                / f"{cfg['reference']}.py").Reference(
            n, src, dst, w, rank, trees=trees, cap=cap,
            device=dev)
        wrong = {1 + i for i, x in enumerate(per_cycle) if x}
        full = 0
        for c, table, k in tables:
            bad = check.count_rows_differing(table, ref.table(k))
            full += bad
            if bad:
                wrong.add(c)
        first_bad = int(check.rows_differing(
            *first_rows, *_rows(ref.table(trees), idx)).sum())
        if first_bad:
            wrong.add(0)
        ref = tables = first_rows = None
    print("chlbench: spans " + ", ".join(
        f"{name} {(t1 - t0) / 1e9:.3f} s" for name, t0, t1 in spans.items
        if name in ("inputs", "graph_build", "policy", "warm_up", "window",
                    "reference")), file=sys.stderr)
    print(f"chlbench: {len(cycles)} cycles, {len(records)} batches, sweeps "
          f"{[rec.sweeps for rec in records[:8]]}, longest batch "
          f"{est_batch:.3f} s",
          file=sys.stderr)
    checks = {
        "full_rows_differing": {"value": full, "limit": 0},
        "sampled_rows_differing": {"value": first_bad + sum(per_cycle),
                                   "limit": 0},
        "overflowed_tables": {"value": overflow, "limit": 0}}

    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": 1, "memory_peak_bytes": int(peak or 0)}
    busy = breakdown = prefix = None
    if tracer is not None:
        summary = trace.summarize(tracer, spans, (
            int(t_start * 1e9), int(t_end * 1e9)))
        if summary is not None:
            busy = summary["busy_s"]
            device["busy_s"] = summary["busy_s"]
            device["window_s"] = summary["window_s"]
            breakdown = summary["breakdown"]
        prefix = least_work.in_degree_prefix(n, src, dst, device=dev)
    return SimpleNamespace(
        correct=check.within(checks), attempted=len(cycles),
        failed=len(wrong), checks=checks, device=device,
        breakdown=breakdown, setup_s=t_start - ctx.t0, window_s=window_s,
        trees=sum(rec.trees for rec in records), records=records, batch=B,
        peak_bytes=peak, busy_s=busy, traced_window_s=device.get("window_s"),
        in_degree_prefix=prefix, peaks=least_work.peaks())
