"""The port's fault tolerance against the reference's ``test_ft.py``.

Deterministic fault injection behind the named sites (the reference's
registry, plan JSON and per-site seeded streams, so one plan drives
either package), crash-safe checkpoints (torn-write fallback, commit
crash, transient I/O retried, GC pinning), artifact integrity (save
crash, torn shard, bit flip), the journaled repair protocol, the serve
answer site, and real subprocesses killed with ``os._exit(41)`` at
``engine.commit`` and ``repair.merge`` whose resume or replay lands
bit-identical labels.
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.ft.inject as ref_inject
import repro.graphs as rg
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager, CorruptCheckpointError
from repro_torch.dynamic import (RepairJournal, random_mutations,
                                 store_fingerprint)
from repro_torch.ft import (FAULT_EXIT_CODE, KNOWN_SITES, Fault, FaultPlan,
                            InjectedCrash, TransientIOError, fault_site,
                            faults, flip_bits, torn_write, with_retries)
from repro_torch.ft.harness import (assert_child_killed, assert_child_ok,
                                    assert_index_bit_identical,
                                    index_arrays, run_child)
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.index.store import CorruptArtifactError, shard_filename

torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")
CHILD_ENV = {"PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}


def road(seed=2):
    g = interop.graph(rg.grid_road(6, 6, seed=seed))
    return g, degree_ranking(g)


def dense_index(batch=8):
    g, rank = road()
    return g, rank, build(g, rank, BuildPlan(algo="plant", batch=batch),
                          device="cpu")


def stores_equal(a, b) -> bool:
    sa, sb = list(a.shard_arrays()), list(b.shard_arrays())
    if [k for k, _ in sa] != [k for k, _ in sb]:
        return False
    return all(np.array_equal(x[key], y[key])
               for (_, x), (_, y) in zip(sa, sb)
               for key in ("hubs", "dist", "count"))


# ---------------------------------------------------------- FaultPlan

def test_registry_and_constants_equal_the_reference():
    assert KNOWN_SITES == ref_inject.KNOWN_SITES
    assert FAULT_EXIT_CODE == ref_inject.FAULT_EXIT_CODE == 41
    from repro_torch.ft import ENV_PLAN, FAULT_KINDS
    assert ENV_PLAN == ref_inject.ENV_PLAN
    assert FAULT_KINDS == ref_inject.FAULT_KINDS
    assert issubclass(InjectedCrash, BaseException)
    assert not issubclass(InjectedCrash, Exception)


def test_fault_plan_rejects_unknown_site():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan({"definitely.not.a.site": [Fault("crash")]})
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("meteor")


def test_fault_plan_json_roundtrip_across_packages():
    plan = FaultPlan({"engine.commit": [Fault("crash", after=2, hard=True)],
                      "spill.query": [Fault("io", count=3)],
                      "artifact.save.shard": [Fault("torn",
                                                    keep_fraction=0.25)]},
                     seed=7)
    back = FaultPlan.from_json(plan.to_json())
    assert back.seed == 7 and back.sites == plan.sites
    # the reference reads the port's JSON, and the port the reference's
    ref = ref_inject.FaultPlan.from_json(plan.to_json())
    assert ref.seed == 7
    assert {k: [f.to_dict() for f in v] for k, v in ref.sites.items()} == \
        {k: [f.to_dict() for f in v] for k, v in plan.sites.items()}
    again = FaultPlan.from_json(ref.to_json())
    assert again.sites == plan.sites and again.to_json() == ref.to_json()


def test_fault_plan_site_rng_equals_the_reference():
    a = FaultPlan({}, seed=3)._rng("artifact.load.shard")
    b = ref_inject.FaultPlan({}, seed=3)._rng("artifact.load.shard")
    assert np.array_equal(a.integers(0, 1 << 30, 8),
                          b.integers(0, 1 << 30, 8))


def test_crash_fires_after_n_hits():
    plan = FaultPlan({"engine.commit": [Fault("crash", after=1)]})
    with faults(plan):
        fault_site("engine.commit")            # hit 1 passes
        with pytest.raises(InjectedCrash):
            fault_site("engine.commit")        # hit 2 crashes
        fault_site("engine.commit")            # hit 3 passes again
    assert plan.fired == [("engine.commit", "crash")]
    fault_site("engine.commit")                # uninstalled: a no-op


def test_io_fault_window_matches_retry_budget():
    plan = FaultPlan({"checkpoint.write": [Fault("io", count=2)]})
    with faults(plan):
        with_retries(lambda: fault_site("checkpoint.write"),
                     base_delay_s=0.0)
    assert plan.fired == [("checkpoint.write", "io")] * 2
    plan = FaultPlan({"checkpoint.write": [Fault("io", count=5)]})
    with faults(plan):
        with pytest.raises(TransientIOError):
            with_retries(lambda: fault_site("checkpoint.write"),
                         retries=3, base_delay_s=0.0)


def test_injected_crash_is_never_retried():
    plan = FaultPlan({"engine.commit": [Fault("crash")]})
    calls = {"n": 0}

    def body():
        calls["n"] += 1
        fault_site("engine.commit")

    with faults(plan):
        with pytest.raises(InjectedCrash):
            with_retries(body, base_delay_s=0.0)
    assert calls["n"] == 1          # BaseException: no second attempt


def test_torn_write_and_flip_bits_equal_the_reference(tmp_path):
    blob = bytes(range(200))
    paths = []
    for name in ("port", "ref"):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(blob)
        paths.append(p)
    assert torn_write(paths[0], 0.25) == ref_inject.torn_write(paths[1],
                                                               0.25) == 50
    offs = flip_bits(paths[0], FaultPlan({}, seed=1)._rng("x"), flips=3)
    ref_offs = ref_inject.flip_bits(
        paths[1], ref_inject.FaultPlan({}, seed=1)._rng("x"), flips=3)
    assert offs == ref_offs and len(offs) == 3
    got, want = (open(p, "rb").read() for p in paths)
    assert got == want and len(got) == 50 and got != blob[:50]


def test_hard_crash_kills_subprocess():
    plan = FaultPlan({"engine.commit": [Fault("crash", hard=True)]})
    proc = run_child(
        ["-c", "from repro_torch.ft.inject import fault_site; "
               "fault_site('engine.commit'); print('survived')"],
        plan=plan, env=CHILD_ENV, timeout=120)
    assert_child_killed(proc)
    assert proc.returncode == FAULT_EXIT_CODE
    assert "survived" not in proc.stdout
    assert_child_ok(run_child(["-c", "print('fine')"], env=CHILD_ENV,
                              timeout=120))


# --------------------------------------------------------- checkpoint

def ckpt_state():
    return {"a": np.arange(12, dtype=np.int64),
            "b": torch.linspace(0.0, 1.0, 7)}


def test_checkpoint_torn_newest_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    st = ckpt_state()
    mgr.save(1, st, data_state={"pos": 1})
    mgr.save(2, {k: v + 1 for k, v in st.items()}, data_state={"pos": 2})
    torn_write(os.path.join(mgr._step_dir(2), "arrays.npz"), 0.4)
    with pytest.warns(UserWarning, match="skipping corrupt"):
        assert mgr.latest_intact_step() == 1
    with pytest.warns(UserWarning, match="skipping corrupt"):
        state, step, data = mgr.restore(st)
    assert step == 1 and data == {"pos": 1}
    np.testing.assert_array_equal(state["a"], st["a"])
    assert torch.equal(state["b"], st["b"])
    with pytest.raises(CorruptCheckpointError, match="CRC|BadZip"):
        mgr.restore(st, step=2)
    with pytest.raises(CorruptCheckpointError):
        mgr.peek(step=2)


def test_checkpoint_all_torn_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, ckpt_state())
    torn_write(os.path.join(mgr._step_dir(1), "arrays.npz"), 0.4)
    with pytest.warns(UserWarning):
        with pytest.raises(CorruptCheckpointError, match="no intact step"):
            mgr.latest_intact_step()


def test_checkpoint_commit_crash_leaves_no_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    plan = FaultPlan({"checkpoint.commit": [Fault("crash")]})
    with faults(plan):
        with pytest.raises(InjectedCrash):
            mgr.save(3, ckpt_state())
    assert mgr.all_steps() == []           # the rename never happened
    mgr.save(3, ckpt_state())              # site healed: a clean save
    assert mgr.all_steps() == [3]
    assert mgr.verify_step(3) is None


def test_checkpoint_write_transient_io_is_retried(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    plan = FaultPlan({"checkpoint.write": [Fault("io", count=2)]})
    with faults(plan):
        mgr.save(1, ckpt_state())          # retries absorb the fault
    assert plan.fired == [("checkpoint.write", "io")] * 2
    assert mgr.latest_intact_step() == 1


def test_checkpoint_bitflip_at_write_is_detected(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, ckpt_state())
    plan = FaultPlan({"checkpoint.write": [Fault("bitflip", flips=8)]},
                     seed=4)
    with faults(plan):
        mgr.save(2, ckpt_state())
    assert plan.fired == [("checkpoint.write", "bitflip")]
    assert mgr.verify_step(2) is not None
    with pytest.warns(UserWarning, match="skipping corrupt"):
        assert mgr.latest_intact_step() == 1


def test_checkpoint_gc_pins_steps_being_read(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    st = ckpt_state()
    mgr.save(1, st)
    mgr.save(2, st)
    mgr._reading.add(1)                    # a concurrent restore
    mgr.save(3, st)
    mgr.save(4, st)
    assert 1 in mgr.all_steps(), "GC deleted a step being read"
    assert 2 not in mgr.all_steps()
    mgr._reading.discard(1)
    mgr.save(5, st)
    assert mgr.all_steps() == [4, 5]


# ----------------------------------------------------------- artifact

def test_artifact_bitflip_rejected_at_load(tmp_path):
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    shard = os.path.join(d, shard_filename(0))
    with open(shard, "r+b") as f:
        f.seek(os.path.getsize(shard) // 3)
        byte = f.read(1)[0]
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte ^ 0x10]))
    with pytest.raises(CorruptArtifactError, match="sha256 mismatch"):
        CHLIndex.load(d, rank=rank, device="cpu")


def test_artifact_save_crash_leaves_no_directory(tmp_path):
    g, rank, idx = dense_index()
    d = str(tmp_path / "idx")
    plan = FaultPlan({"artifact.save.commit": [Fault("crash")]})
    with faults(plan):
        with pytest.raises(InjectedCrash):
            idx.save(d)
    assert not os.path.exists(d), "the staged swap landed a partial dir"
    idx.save(d)
    back = CHLIndex.load(d, rank=rank, device="cpu")
    assert stores_equal(idx.store, back.store)


def test_artifact_save_crash_keeps_the_old_artifact(tmp_path):
    """An overwrite that crashes before the swap leaves the previous
    artifact loadable and intact."""
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    before = index_arrays(d)
    with faults(FaultPlan({"artifact.save.commit": [Fault("crash")]})):
        with pytest.raises(InjectedCrash):
            dense_index(batch=4)[2].save(d)
    after = index_arrays(d)
    assert set(before) == set(after)
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_artifact_torn_shard_write_cannot_serve_wrong_answers(tmp_path):
    g, rank, idx = dense_index()
    d = str(tmp_path / "idx")
    plan = FaultPlan({"artifact.save.shard": [Fault("torn",
                                                    keep_fraction=0.5)]})
    with faults(plan):
        idx.save(d)                        # the save itself survives
    with pytest.raises(CorruptArtifactError):
        CHLIndex.load(d, rank=rank, device="cpu")


def test_artifact_site_io_surfaces_and_load_site_fires(tmp_path):
    g, rank, idx = dense_index()
    d = str(tmp_path / "idx")
    plan = FaultPlan({"artifact.save.shard": [Fault("io", count=2)]})
    # the io fault fires at the site after the write: with_retries
    # wraps the write alone, so the site's io surfaces to the caller
    with faults(plan):
        with pytest.raises(TransientIOError):
            idx.save(d)
    idx.save(d)
    plan = FaultPlan({"artifact.load.shard": [Fault("crash")]})
    with faults(plan):
        with pytest.raises(InjectedCrash):
            CHLIndex.load(d, rank=rank, device="cpu")
    assert plan.fired == [("artifact.load.shard", "crash")]


def test_engine_commit_crash_then_resume_bit_identical(tmp_path):
    g, rank = road()
    plan_ = BuildPlan(algo="plant", batch=4)
    ref = build(g, rank, plan_, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    fplan = FaultPlan({"engine.commit": [Fault("crash", after=2)]})
    with faults(fplan):
        with pytest.raises(InjectedCrash):
            build(g, rank, plan_, ckpt=mgr, resume=False, device="cpu")
    assert fplan.fired == [("engine.commit", "crash")]
    mgr.wait()
    assert mgr.latest_intact_step() == 8
    idx = build(g, rank, plan_, ckpt=mgr, resume=True, device="cpu")
    assert stores_equal(idx.store, ref.store), \
        "crash+resume diverged from the uninterrupted build"
    want = ref_build(rg.grid_road(6, 6, seed=2), rank,
                     RefPlan(algo="plant", batch=4))
    assert all(np.array_equal(a.numpy(), np.asarray(b))
               for a, b in zip(idx.table, want.table))


# ------------------------------------------------------ repair journal

def test_journal_protocol_roundtrip(tmp_path):
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    j = RepairJournal.for_artifact(d)
    assert j.pending() is None
    batch = random_mutations(g, np.random.default_rng(5), inserts=1,
                             deletes=1, reweights=1)
    j.begin(batch, idx)
    rec = j.pending()
    assert rec["state"] == "begun"
    assert rec["pre"] == store_fingerprint(idx.store)
    assert j.batch().to_dict() == batch.to_dict()
    with pytest.raises(RuntimeError, match="unfinished repair"):
        j.begin(batch, idx)                # no double begin
    assert j.recover(idx) == "pre"         # store untouched so far
    assert j.pending() is not None         # a pre recovery keeps intent
    idx.apply(batch, graph=g)
    j.record_post(idx)
    assert j.pending()["state"] == "repaired"
    assert j.recover(idx) == "post"
    assert j.pending() is None             # a post recovery retires it
    j.finish()                             # idempotent


def test_journal_flags_out_of_band_change(tmp_path):
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    j = RepairJournal.for_artifact(d)
    j.begin(random_mutations(g, np.random.default_rng(6)), idx)
    g2, rank2 = road(seed=9)
    other = build(g2, rank2, BuildPlan(algo="plant", batch=8),
                  device="cpu")
    assert store_fingerprint(other.store) != store_fingerprint(idx.store)
    with pytest.raises(CorruptArtifactError, match="neither"):
        j.recover(other)
    j.finish()


def test_repair_merge_crash_replay_bit_identical(tmp_path):
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    batch = random_mutations(g, np.random.default_rng(9), inserts=2,
                             deletes=1, reweights=1)
    ref = CHLIndex.load(d, rank=rank, device="cpu")   # uninterrupted
    ref.apply(batch, graph=g)

    victim = CHLIndex.load(d, rank=rank, device="cpu")
    j = RepairJournal.for_artifact(d)
    plan = FaultPlan({"repair.merge": [Fault("crash")]})
    with faults(plan):
        with pytest.raises(InjectedCrash):
            victim.apply(batch, graph=g, journal=j)
    assert stores_equal(victim.store, CHLIndex.load(d, device="cpu").store)
    fresh = CHLIndex.load(d, rank=rank, device="cpu")
    assert j.recover(fresh) == "pre"
    replay = j.batch()
    j.finish()
    fresh.apply(replay, graph=g, journal=j)
    j.finish()
    assert stores_equal(fresh.store, ref.store), \
        "journal replay diverged from the uninterrupted repair"


# ------------------------------------------------------- serve answer

def test_serve_answer_site(tmp_path):
    """An io fault at ``serve.answer`` fails its batch only (the
    breaker counts it); a crash there is never swallowed."""
    g, rank, idx = dense_index()
    svc = idx.serve(batch_size=8, breaker_threshold=0)
    u, v = np.arange(8), np.arange(8)[::-1].copy()
    with faults(FaultPlan({"serve.answer": [Fault("io")]})):
        svc.submit(u, v)
        out = svc.flush()
        assert np.isnan(out).all() and svc.stats_.answer_failures == 1
        svc.submit(u, v)
        assert np.array_equal(svc.flush(), idx.query(u, v))
    with faults(FaultPlan({"serve.answer": [Fault("crash")]})):
        with pytest.raises(InjectedCrash):
            svc.submit(u, v)               # a full batch launches here


# ------------------------------------------- real kills in a subprocess

BUILD_CHILD = """
import sys
import numpy as np
from repro_torch.checkpoint import CheckpointManager
from repro_torch.graphs import grid_road
from repro_torch.index import BuildPlan, build
g = grid_road(6, 6, seed=2)
rank = np.load(sys.argv[1])
build(g, rank, BuildPlan(algo="plant", batch=4),
      ckpt=CheckpointManager(sys.argv[2], keep=100), device="cpu")
print("finished")
"""


def test_hard_kill_at_engine_commit_then_resume(tmp_path):
    g, rank = road()
    np.save(tmp_path / "rank.npy", rank)
    ckpt = str(tmp_path / "ckpt")
    plan = FaultPlan({"engine.commit": [Fault("crash", after=4,
                                              hard=True)]})
    proc = run_child(["-c", BUILD_CHILD, str(tmp_path / "rank.npy"), ckpt],
                     plan=plan, env=CHILD_ENV, timeout=300)
    assert_child_killed(proc)
    assert "finished" not in proc.stdout
    mgr = CheckpointManager(ckpt, keep=100)
    committed = mgr.latest_intact_step()
    assert committed is not None and 0 < committed < g.n
    resumed = build(g, rank, BuildPlan(algo="plant", batch=4), ckpt=mgr,
                    resume=True, device="cpu")
    assert resumed.report.supersteps and mgr.peek()["pos"] == g.n
    ref = build(g, rank, BuildPlan(algo="plant", batch=4), device="cpu")
    assert stores_equal(resumed.store, ref.store)


REPAIR_CHILD = """
import json
import sys
from repro_torch.dynamic import MutationBatch, RepairJournal
from repro_torch.graphs import grid_road
from repro_torch.index import CHLIndex
g = grid_road(6, 6, seed=2)
idx = CHLIndex.load(sys.argv[1], device="cpu")
batch = MutationBatch.from_dict(json.loads(sys.argv[2]))
idx.apply(batch, graph=g, journal=RepairJournal.for_artifact(sys.argv[1]))
idx.save(sys.argv[1])
print("finished")
"""


@pytest.mark.parametrize("site", ["repair.merge", "artifact.save.commit"])
def test_hard_kill_during_repair_then_recover(tmp_path, site):
    """A child killed at the merge (pre state on disk) or at the
    artifact swap (pre state on disk, post recorded) recovers through
    the journal to the uninterrupted repair's arrays."""
    g, rank, idx = dense_index()
    d = idx.save(str(tmp_path / "idx"))
    batch = random_mutations(g, np.random.default_rng(9), inserts=1,
                             deletes=1, reweights=1)
    want_dir = str(tmp_path / "want")
    ref = CHLIndex.load(d, device="cpu")
    ref.apply(batch, graph=g)
    ref.save(want_dir)
    plan = FaultPlan({site: [Fault("crash", hard=True)]})
    proc = run_child(["-c", REPAIR_CHILD, d, json.dumps(batch.to_dict())],
                     plan=plan, env=CHILD_ENV, timeout=300)
    assert_child_killed(proc)
    j = RepairJournal.for_artifact(d)
    assert j.pending()["state"] == ("begun" if site == "repair.merge"
                                    else "repaired")
    fresh = CHLIndex.load(d, device="cpu")
    assert j.recover(fresh) == "pre"
    replay = j.batch()
    j.finish()
    fresh.apply(replay, graph=g, journal=j)
    fresh.save(d)
    j.finish()
    assert_index_bit_identical(d, want_dir)


def test_run_child_inherits_env_without_a_plan():
    proc = run_child(["-c", "import os; print(os.environ.get("
                            "'REPRO_FAULT_PLAN', 'none'))"],
                     env=CHILD_ENV, timeout=120)
    assert_child_ok(proc)
    assert proc.stdout.strip() == "none"
