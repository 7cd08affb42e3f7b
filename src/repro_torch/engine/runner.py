"""The superstep engine: one loop for every construction algorithm.

``run(policy, sink)`` owns root scheduling, the per-superstep typed
records, the packed one-fetch stats protocol, overflow bookkeeping and
checkpoint/resume:

- an ``eager_stats`` policy (GLL/LCC/paraPLL, whose flush rule is
  decided on the host), and every run with a checkpoint manager, has
  its record read and the sink's overflow checked at every commit, so
  a dropped label raises before anything is saved; the others' stats
  rows are fetched in one transfer after the loop;
- with ``ckpt`` (a ``repro_torch.checkpoint.CheckpointManager``), every
  committed superstep saves the sink's label state and the schedule
  cursor (root position, policy meta and counters, records so far)
  after the ``engine.commit`` fault site, on the manager's writer
  thread;
- ``resume=True`` restores the newest intact compatible checkpoint and
  continues the schedule from its cursor. A checkpoint of another
  algorithm, kind, build input (fingerprint), schedule config or sink
  layout is cleared instead; one written under a *smaller* label cap
  is padded to the current cap, which is how ``index.build``'s
  overflow regrow resumes from the last committed superstep.

Checkpoints are the reference package's format, key for key, so either
package resumes from the other's. ``run_build(g, rank, algo=...)``
picks the policy and sink for an algorithm.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.policies import Policy, StepOutcome
from repro_torch.engine.records import (SuperstepRecord, fetch_stat_rows,
                                        record_from_row)
from repro_torch.ft.inject import fault_site

#: data_state format tag for engine checkpoints
CKPT_FORMAT = 1


class EngineResult(NamedTuple):
    records: List[SuperstepRecord]
    counters: Dict[str, int]
    sink: object
    extras: dict
    resumed_from: Optional[int]      # committed cursor restored, or None


def _encode_records(records: List[SuperstepRecord]):
    """Records as compact i32/f32 arrays (stored in the checkpoint's
    ``arrays.npz``, not its JSON manifest, which would grow
    quadratically over a run). Returns (arrays, mode vocabulary)."""
    vocab: List[str] = []
    ids: Dict[str, int] = {}
    packed = np.full((len(records), 5), -1, dtype=np.int32)
    psi = np.full(len(records), np.nan, dtype=np.float32)
    for i, r in enumerate(records):
        if r.mode not in ids:
            ids[r.mode] = len(vocab)
            vocab.append(r.mode)
        row = (ids[r.mode], r.labels, r.explored, r.sweeps, r.trees)
        packed[i] = [-1 if v is None else int(v) for v in row]
        if r.psi is not None:
            psi[i] = r.psi
    return {"packed": packed, "psi": psi}, vocab


def _decode_records(arrays, vocab: List[str]) -> List[SuperstepRecord]:
    out = []
    for row, p in zip(np.asarray(arrays["packed"]),
                      np.asarray(arrays["psi"])):
        mode_id, labels, explored, sweeps, trees = (int(v) for v in row)
        out.append(SuperstepRecord(
            mode=vocab[mode_id],
            labels=None if labels < 0 else labels,
            explored=None if explored < 0 else explored,
            sweeps=None if sweeps < 0 else sweeps,
            psi=None if np.isnan(p) else float(p),
            trees=None if trees < 0 else trees))
    return out


def _meta_compatible(saved: Optional[dict], current: dict) -> bool:
    """Sink metadata check for resume: a saved cap *smaller* than the
    current one is compatible (the restored arrays are padded), any
    other field must match exactly."""
    if not isinstance(saved, dict):
        return False
    saved = dict(saved)
    current = dict(current)
    saved_cap = saved.pop("cap", None)
    cur_cap = current.pop("cap", None)
    if saved != current:
        return False
    if saved_cap is None or cur_cap is None:
        return saved_cap == cur_cap
    return saved_cap <= cur_cap


def _try_restore(ckpt, policy: Policy, sink):
    """Restore the newest compatible checkpoint; returns ``(pos, size,
    records)`` or None. Incompatible checkpoints are cleared so their
    higher step numbers cannot shadow this run's resume points."""
    ckpt.wait()                   # a save of this manager still in flight
    # the newest *intact* step: a torn newest checkpoint (a crash
    # mid-commit) falls back to the previous one
    step = ckpt.latest_intact_step()
    if step is None:
        return None
    meta = ckpt.peek(step)
    if (meta.get("engine") != CKPT_FORMAT
            or meta.get("algo") != policy.name
            or meta.get("kind", "build") != policy.kind
            or meta.get("fingerprint") != policy.fingerprint
            or meta.get("config") != policy.config()
            or not _meta_compatible(meta.get("sink"), sink.meta())):
        ckpt.clear()
        return None
    template = {"sink": sink.state_arrays(),
                "records": {"packed": np.zeros((0, 5), np.int32),
                            "psi": np.zeros(0, np.float32)}}
    state, _, _ = ckpt.restore(template, step=step)
    sink.load_state(state["sink"])
    policy.load_meta(meta.get("policy") or {})
    policy.load_counters(meta.get("counters") or {})
    records = _decode_records(state["records"], meta.get("mode_vocab", []))
    return int(meta["pos"]), meta.get("size"), records


def run(policy: Policy, sink, *, ckpt=None, resume: bool = False,
        verbose: bool = False) -> EngineResult:
    """Drive ``policy``'s schedule to completion, emitting into
    ``sink``; returns typed records, counters and the filled sink."""
    schedule = policy.schedule()
    eager = policy.eager_stats or ckpt is not None
    records: List[Optional[SuperstepRecord]] = []
    deferred: List[tuple] = []          # (record index, outcome)
    pos, size = 0, None
    resumed_from: Optional[int] = None

    if ckpt is not None and resume:
        restored = _try_restore(ckpt, policy, sink)
        if restored is not None:
            pos, size, records = restored
            resumed_from = pos
            if verbose:
                print(f"[resume] superstep cursor={pos} size={size}")

    policy.begin(pos, resumed_from is not None)

    def commit(out: StepOutcome, end_pos: int,
               next_size: Optional[int]) -> None:
        if eager:
            rec = out.record if out.record is not None else \
                record_from_row(out.mode, fetch_stat_rows([out.stats])[0],
                                trees=out.trees)
            if sink.overflowed():
                # raise before committing a checkpoint: inserts drop
                # labels on overflow, and a saved corrupt table would
                # be restored by the next resume
                if ckpt is not None:
                    ckpt.wait()
                sink.raise_on_overflow()
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
        if ckpt is not None:
            fault_site("engine.commit")
            rec_arrays, vocab = _encode_records(records)
            ckpt.save(end_pos, {"sink": sink.state_arrays(),
                                "records": rec_arrays},
                      data_state={
                          "engine": CKPT_FORMAT,
                          "algo": policy.name,
                          "kind": policy.kind,
                          "fingerprint": policy.fingerprint,
                          "config": policy.config(),
                          "sink": sink.meta(),
                          "policy": policy.meta(),
                          "counters": policy.counters(),
                          "mode_vocab": vocab,
                          "pos": end_pos,
                          "size": next_size},
                      blocking=False)

    if resumed_from is None:
        pre = policy.prologue(sink)
        if pre is not None:
            out, pos = pre
            commit(out, pos, size)
    for st in schedule.steps(start=pos, size=size):
        out = policy.step(st, sink)
        if out is not None:
            commit(out, st.end, st.next_size)
    tail = policy.epilogue(sink)
    if tail is not None:
        commit(tail, schedule.total, None)
    if ckpt is not None:
        ckpt.wait()

    rows = fetch_stat_rows([o.stats for _, o in deferred])   # ONE transfer
    for (i, o), row in zip(deferred, rows):
        records[i] = record_from_row(o.mode, row, trees=o.trees)
    if not eager:
        sink.raise_on_overflow()
    return EngineResult(records=records, counters=policy.counters(),
                        sink=sink, extras=policy.extras(sink),
                        resumed_from=resumed_from)


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
    to ``plant`` only. ``ckpt`` checkpoints every committed superstep;
    ``resume`` continues from the newest compatible one."""
    from repro_torch.core import labels as lbl
    from repro_torch.engine.policies import (GLLPolicy, PlantPolicy,
                                             PLLRefPolicy)
    from repro_torch.engine.sink import DenseSink

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
    return run(policy, DenseSink(g.n, cap, dev), ckpt=ckpt, resume=resume,
               verbose=verbose)
