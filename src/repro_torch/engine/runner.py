"""The superstep engine: one loop for every construction algorithm.

``run(policy, sink)`` owns root scheduling, the per-superstep typed
records, the packed one-fetch stats protocol and overflow bookkeeping.
An ``eager_stats`` policy (GLL/LCC/paraPLL, whose flush rule is decided
on the host) has its record read and the sink's overflow checked at
every commit, so a dropped label raises before the loop goes on; the
others' stats rows are fetched in one transfer after the loop.
``run_build(g, rank, algo=...)`` picks the policy and sink for an
algorithm. Checkpoint and resume (``ckpt=``) are not ported yet and
raise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.policies import Policy, StepOutcome
from repro_torch.engine.records import (SuperstepRecord, fetch_stat_rows,
                                        record_from_row)


class EngineResult(NamedTuple):
    records: List[SuperstepRecord]
    counters: Dict[str, int]
    sink: object
    extras: dict


def run(policy: Policy, sink, *, verbose: bool = False) -> EngineResult:
    """Drive ``policy``'s schedule to completion, emitting into
    ``sink``; returns typed records, counters and the filled sink."""
    schedule = policy.schedule()
    eager = policy.eager_stats
    records: List[Optional[SuperstepRecord]] = []
    deferred: List[tuple] = []          # (record index, outcome)

    def commit(out: StepOutcome, end_pos: int) -> None:
        if eager:
            rec = out.record if out.record is not None else \
                record_from_row(out.mode, fetch_stat_rows([out.stats])[0],
                                trees=out.trees)
            sink.raise_on_overflow()    # inserts drop labels on overflow
        elif out.record is not None:
            rec = out.record
        else:
            records.append(None)        # placeholder, filled below
            deferred.append((len(records) - 1, out))
            rec = None
        if rec is not None:
            records.append(rec)
            policy.observe(rec)
        if verbose:
            print(f"superstep end={end_pos:6d} mode={out.mode}")

    policy.begin(0, False)
    pos = 0
    pre = policy.prologue(sink)
    if pre is not None:
        out, pos = pre
        commit(out, pos)
    for st in schedule.steps(start=pos):
        out = policy.step(st, sink)
        if out is not None:
            commit(out, st.end)
    tail = policy.epilogue(sink)
    if tail is not None:
        commit(tail, schedule.total)

    rows = fetch_stat_rows([o.stats for _, o in deferred])   # ONE transfer
    for (i, o), row in zip(deferred, rows):
        records[i] = record_from_row(o.mode, row, trees=o.trees)
    if not eager:
        sink.raise_on_overflow()
    return EngineResult(records=records, counters=policy.counters(),
                        sink=sink, extras=policy.extras(sink))


#: algorithms this port builds; the rest of the reference's list is
#: still to port (ROADMAP Queue 1)
PORTED_ALGOS = ("plant", "pll-ref", "gll", "lcc", "parapll")


def unported_algo(algo: str) -> NotImplementedError:
    """The refusal for an algorithm this port does not build yet,
    citing the ROADMAP item that ports it."""
    item = ("item 8, the directed half" if algo == "directed"
            else "item 11, distributed")
    return NotImplementedError(
        f"algo={algo!r} is not ported yet (ROADMAP Queue 1, {item}); "
        f"this port builds {', '.join(PORTED_ALGOS)}")


def run_build(g, rank: np.ndarray, *, algo: str, batch: int = 8,
              cap: Optional[int] = None, alpha: Optional[float] = 4.0,
              rank_queries: bool = True, clean: bool = True,
              plant_first_superstep: bool = False,
              roots_order: Optional[np.ndarray] = None,
              device: DeviceLike = None, ckpt=None, resume: bool = False,
              verbose: bool = False) -> EngineResult:
    """Construct labels for ``algo`` through the engine on ``device``
    (default: the card). ``lcc`` forces ``alpha=None``; ``parapll``
    also turns rank queries and cleaning off. ``roots_order`` applies
    to ``plant`` only."""
    from repro_torch.core import labels as lbl
    from repro_torch.engine.policies import (GLLPolicy, PlantPolicy,
                                             PLLRefPolicy)
    from repro_torch.engine.sink import DenseSink

    if ckpt is not None or resume:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP Queue 1, item 5)")
    if algo not in PORTED_ALGOS:
        raise unported_algo(algo)
    if roots_order is not None and algo != "plant":
        raise ValueError(f"roots_order applies to algo='plant', not "
                         f"{algo!r}")
    dev = resolve_device(device)
    cap = cap or lbl.default_cap(g.n)
    if algo == "plant":
        policy = PlantPolicy(g, rank, batch=batch, device=dev,
                             roots_order=roots_order)
    elif algo == "pll-ref":
        policy = PLLRefPolicy(g, rank, batch=batch, device=dev)
    else:
        if algo == "lcc":
            alpha = None
        elif algo == "parapll":
            alpha, rank_queries, clean = None, False, False
        policy = GLLPolicy(g, rank, batch=batch, cap=cap, device=dev,
                           alpha=alpha, rank_queries=rank_queries,
                           clean=clean,
                           plant_first_superstep=plant_first_superstep,
                           mode_name=algo)
    return run(policy, DenseSink(g.n, cap, dev), verbose=verbose)
