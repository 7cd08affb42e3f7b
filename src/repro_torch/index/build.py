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

The port builds ``plant``, ``pll-ref``, ``gll``, ``lcc`` and
``parapll`` into ``store="dense"``; other algorithms and stores raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelOverflowError
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine import PORTED_ALGOS, run_build
from repro_torch.engine.runner import unported_algo
from repro_torch.index.artifact import CHLIndex
from repro_torch.index.plan import BuildPlan
from repro_torch.index.report import BuildReport, OverflowEvent
from repro_torch.index.store import DenseStore
from repro_torch.kernels.ell_relax import layout_plan, windowed_note


def build(g, rank: np.ndarray, plan: Optional[BuildPlan] = None, *,
          device: DeviceLike = None, ckpt=None, resume: bool = False,
          verbose: bool = False) -> CHLIndex:
    """Construct a :class:`CHLIndex` per ``plan`` on ``device``
    (default: the card; raises without CUDA). ``ckpt`` (a
    ``CheckpointManager``) checkpoints every committed superstep;
    ``resume`` continues from the last compatible one."""
    dev = resolve_device(device)
    plan = plan or BuildPlan()
    if plan.algo not in PORTED_ALGOS:
        raise unported_algo(plan.algo)
    if plan.store != "dense":
        raise NotImplementedError(
            f"store={plan.store!r} is not ported yet (ROADMAP Queue 1, "
            "item 9); this port builds store='dense'")
    if g.directed:
        raise ValueError(f"algo={plan.algo!r} needs an undirected graph")
    n = g.n
    cap = min(plan.cap or lbl.default_cap(n), n)
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
                            cap=cap, alpha=plan.alpha, device=dev,
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

    store = DenseStore(res.sink.table())
    total = store.total_labels
    report = BuildReport(
        algo=plan.algo, wall_s=wall, total_labels=total,
        als=total / max(1, n), cap=cap, supersteps=list(res.records),
        overflow_events=overflow_events, notes=notes,
        cleaned=int(res.counters.get("cleaned", 0)),
        constructed=int(res.counters.get("constructed", 0)))
    return CHLIndex(store, plan=plan, report=report, rank=rank)
