"""The superstep engine: one loop for every construction algorithm.

``run(policy, sink)`` owns root scheduling, the per-superstep typed
records, the packed one-fetch stats protocol and overflow bookkeeping.
``run_build(g, rank, algo=...)`` picks the policy and sink for an
algorithm. This slice ports the single-host PLaNT path; checkpoint and
resume (``ckpt=``) are not ported yet and raise.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.policies import Policy, StepOutcome
from repro_torch.engine.records import (SuperstepRecord, fetch_stat_rows,
                                        record_from_row)


class EngineResult(NamedTuple):
    records: List[SuperstepRecord]
    sink: object


def run(policy: Policy, sink, *, verbose: bool = False) -> EngineResult:
    """Drive ``policy``'s schedule to completion, emitting into
    ``sink``; returns typed records + the filled sink."""
    deferred: List[StepOutcome] = []
    for st in policy.schedule().steps():
        out: Optional[StepOutcome] = policy.step(st, sink)
        if out is None:
            continue
        deferred.append(out)
        if verbose:
            print(f"superstep end={st.end:6d} mode={out.mode}")

    rows = fetch_stat_rows([o.stats for o in deferred])   # ONE transfer
    records = [record_from_row(o.mode, row, trees=o.trees)
               for o, row in zip(deferred, rows)]
    sink.raise_on_overflow()
    return EngineResult(records=records, sink=sink)


#: algorithms this slice builds; the rest of the reference's list is
#: still to port (ROADMAP Queue 1)
PORTED_ALGOS = ("plant",)


def run_build(g, rank: np.ndarray, *, algo: str, batch: int = 8,
              cap: Optional[int] = None,
              roots_order: Optional[np.ndarray] = None,
              device: DeviceLike = None, ckpt=None, resume: bool = False,
              verbose: bool = False) -> EngineResult:
    """Construct labels for ``algo`` through the engine on ``device``
    (default: the card)."""
    from repro_torch.core import labels as lbl
    from repro_torch.engine.policies import PlantPolicy
    from repro_torch.engine.sink import DenseSink

    if ckpt is not None or resume:
        raise NotImplementedError(
            "checkpoint/resume is not ported yet (ROADMAP Queue 1, item 5)")
    if algo not in PORTED_ALGOS:
        raise NotImplementedError(
            f"algo={algo!r} is not ported yet (ROADMAP Queue 1, items "
            "8 and 11); this slice builds algo='plant'")
    dev = resolve_device(device)
    cap = cap or lbl.default_cap(g.n)
    policy = PlantPolicy(g, rank, batch=batch, device=dev,
                         roots_order=roots_order)
    sink = DenseSink(g.n, cap, dev)
    return run(policy, sink, verbose=verbose)
