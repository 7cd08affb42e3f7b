"""`build(graph, rank, plan) -> CHLIndex` — the construction facade.

Translates a :class:`BuildPlan` into an engine run on the build's
device, takes the engine's typed records into a :class:`BuildReport`
and packages the labels as a :class:`CHLIndex`. A label-table overflow
retries with the cap grown geometrically (``plan.cap_growth``, clamped
to n, at most ``plan.max_cap_retries`` times); every regrow is recorded
in ``report.overflow_events``. With a checkpoint manager attached
(``ckpt=``), every committed superstep is checkpointed, and a regrow
retry resumes from the last committed superstep (the engine pads the
smaller-cap state to the grown cap) instead of restarting the build.

Label residency follows the plan. ``store="sharded"`` builds of a
streaming algorithm (PLaNT, pll-ref: emissions final on arrival)
hub-partition each superstep's labels straight into per-shard arrays
and never hold the dense ``[n, cap]`` table; GLL, LCC and paraPLL
consult their global table while building, so they build dense and
re-home. ``store="compressed"`` builds as ``"sharded"`` does (streamed
for PLaNT/pll-ref) and encodes the shards afterwards; the report notes
the codec. ``algo="directed"`` builds the dense ``L_out``/``L_in``
pair. The distributed algorithms (``dgll``, ``hybrid``, the default,
and ``plant-dist``) build on a node mesh (``mesh=``, default: one node
per card, at most ``plan.mesh_devices``): their per-node partitions
are merged into the store and handed to the index as ``partitioned``,
from which QFDL serves.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelOverflowError
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import STREAMING_ALGOS, run_build
from repro_torch.index.artifact import CHLIndex
from repro_torch.index.plan import BuildPlan
from repro_torch.index.report import BuildReport, OverflowEvent
from repro_torch.index.store import CompressedStore, DenseStore, ShardedStore
from repro_torch.kernels.ell_relax import layout_plan, windowed_note


def _resolve_shards(plan: BuildPlan, device,
                    extras: Optional[dict] = None) -> int:
    """The shard-count rule: the plan's ``shards`` if set, else the
    build mesh's size (distributed algorithms), else the number of
    devices of the build's device type (1 on the CPU)."""
    if plan.shards:
        return plan.shards
    K = int((extras or {}).get("q") or 1)
    if K == 1 and device.type == "cuda":
        K = max(1, torch.cuda.device_count())
    return K


def build(g, rank: np.ndarray, plan: Optional[BuildPlan] = None, *,
          mesh=None, device: DeviceLike = None, ckpt=None,
          resume: bool = False, verbose: bool = False) -> CHLIndex:
    """Construct a :class:`CHLIndex` per ``plan`` (default: the hybrid)
    on ``device`` (default: the card; raises without CUDA). A
    distributed algorithm builds on ``mesh`` (a `NodeMesh`, e.g.
    ``NodeMesh.logical(8, "cuda")``; default: one node per device of
    ``device``'s type, at most ``plan.mesh_devices``), and the store
    lands on node 0's device. ``ckpt`` (a ``CheckpointManager``)
    checkpoints every committed superstep; ``resume`` continues from
    the last compatible one."""
    plan = plan or BuildPlan()
    if plan.distributed:
        from repro_torch.parallel.mesh import make_node_mesh
        mesh = mesh or make_node_mesh(plan.mesh_devices, device=device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    if plan.algo == "directed" and not g.directed:
        raise ValueError("algo='directed' needs a directed graph")
    if plan.algo != "directed" and g.directed:
        raise ValueError(f"algo={plan.algo!r} needs an undirected "
                         "graph; use algo='directed'")
    if plan.algo == "directed" and plan.store != "dense":
        raise ValueError("directed builds support only store='dense' "
                         "(sharded directed serving is a ROADMAP item)")
    n = g.n
    cap = min(plan.cap or lbl.default_cap(n), n)
    # compressed builds stream through the same hub-partitioned sink;
    # the shards are encoded after construction
    streaming_shards = (_resolve_shards(plan, dev)
                        if plan.store in ("sharded", "compressed")
                        and plan.algo in STREAMING_ALGOS else None)
    notes = []
    # the host oracle (pll-ref) runs no sweeps
    windows = (layout_plan(n, dev, bb=plan.batch)
               if plan.algo != "pll-ref" else None)
    if windows is not None and windows.num_windows > 1:
        # surface the windowing decision in the report
        notes.append(windowed_note(n, plan.batch, windows))
    overflow_events = []
    t0 = time.perf_counter()
    attempt = 0
    while True:
        try:
            # the first attempt resumes only on request; regrow retries
            # resume whenever checkpoints exist
            res = run_build(g, rank, algo=plan.algo, batch=plan.batch,
                            cap=cap, alpha=plan.alpha, mesh=mesh,
                            beta=plan.beta,
                            first_superstep=plan.first_superstep,
                            eta=plan.eta, hc_cap=plan.hc_cap,
                            psi_threshold=plan.psi_th,
                            compact=plan.compact,
                            streaming_shards=streaming_shards, device=dev,
                            ckpt=ckpt,
                            resume=(resume if attempt == 0
                                    else ckpt is not None),
                            verbose=verbose)
            break
        except LabelOverflowError as e:
            if e.what != "label table":
                raise
            grown = min(max(cap + 1, int(cap * plan.cap_growth)), n)
            if attempt >= plan.max_cap_retries or grown == cap:
                overflow_events.append(
                    OverflowEvent(attempt=attempt, cap=cap,
                                  regrown_to=None))
                raise
            overflow_events.append(
                OverflowEvent(attempt=attempt, cap=cap, regrown_to=grown))
            if verbose:
                print(f"[build] label table overflow at cap={cap}; "
                      f"regrowing to {grown} "
                      f"(attempt {attempt + 1}/{plan.max_cap_retries})")
            cap = grown
            attempt += 1
    wall = time.perf_counter() - t0

    report_kw = dict(
        algo=plan.algo, wall_s=wall, cap=cap, supersteps=list(res.records),
        overflow_events=overflow_events, notes=notes,
        comm_label_slots=int(res.counters.get("comm_label_slots", 0)),
        psi_threshold=res.extras.get("psi_threshold"),
        q=int(res.extras.get("q", 1)),
        cleaned=int(res.counters.get("cleaned", 0)),
        constructed=int(res.counters.get("constructed", 0)))
    if plan.algo == "directed":
        l_out, l_in = res.sink.table("out"), res.sink.table("in")
        total = lbl.total_labels(l_out) + lbl.total_labels(l_in)
        report = BuildReport(total_labels=total, als=total / max(1, 2 * n),
                             **report_kw)
        return CHLIndex(l_out=l_out, l_in=l_in, plan=plan, report=report,
                        rank=rank)
    partitioned = res.extras.get("partitioned")
    if res.sink.kind == "sharded":       # streamed: the shards are the build
        store = ShardedStore.from_accumulator(res.sink.acc, device=dev)
        if plan.store == "compressed":
            store = CompressedStore.from_store(
                store, rank, codec=plan.codec or "bf16",
                exact=plan.quant_exact)
    else:
        if res.sink.kind == "mesh":
            from repro_torch.core.dgll import merge_partitions
            table = merge_partitions(res.sink.tables)
        else:
            table = res.sink.table()
        if plan.store == "sharded":
            store = ShardedStore.from_table(
                table, rank, _resolve_shards(plan, dev, res.extras))
        elif plan.store == "compressed":
            store = CompressedStore.from_table(
                table, rank, codec=plan.codec or "bf16",
                exact=plan.quant_exact,
                shards=_resolve_shards(plan, dev, res.extras))
        else:
            store = DenseStore(table)
    if isinstance(store, CompressedStore):
        if store.exact:
            notes.append(f"quant: codec={store.codec} exact "
                         "(bit-identical round trip validated)")
        else:
            notes.append(f"quant: codec={store.codec} lossy, max "
                         f"label ulp error {store.max_ulp_err}")
    total = store.total_labels
    report = BuildReport(total_labels=total, als=total / max(1, n),
                         **report_kw)
    return CHLIndex(store, plan=plan, report=report, rank=rank,
                    partitioned=partitioned)
