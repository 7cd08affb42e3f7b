"""Checkpoint/resume through the port's engine, against the reference.

Mirrors the reference's ``test_engine.py`` resume tests: a run resumed
from a committed superstep lands on the same label table (slot order
and padding included) as an uninterrupted run, for every ported
algorithm; checkpoints of another graph, batch config or algorithm are
refused; an overflowing build regrows and resumes from its last commit.
Across the packages: the flattened state keys equal
``jax.tree_util.keystr``'s, the ``data_state`` manifests and arrays of
each committed step are equal key for key, and a build checkpointed by
either package resumes in the other to the identical table and
records. Weights are integral f32: every comparison is exact.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.checkpoint import CheckpointManager as RefManager
from repro.core.labels import LabelOverflowError as RefOverflow
from repro.core.pll import pll_undirected
from repro.engine import run_build as ref_run_build
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import flatten
from repro_torch.core import labels as lbl
from repro_torch.core import validate
from repro_torch.core.labels import LabelOverflowError
from repro_torch.engine import run_build
from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
from repro_torch.index import BuildPlan, build

torch.set_num_threads(1)


def small():
    g = rg.scale_free(40, attach=2, seed=1)
    return g, degree_ranking(g)


def tables_equal(a, b) -> bool:
    """Raw bit-identity (slot order included) of two label tables, each
    the port's (tensors) or the reference's (jax arrays)."""
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def drop_steps_after(tmp, mgr, keep: int) -> int:
    """Simulate an interrupt: delete all but the first ``keep``
    committed checkpoints; returns the cursor left."""
    steps = mgr.all_steps()
    assert len(steps) > keep, "scenario needs a later checkpoint to drop"
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(str(tmp), f"step_{s:010d}"))
    return steps[keep - 1]


def port_build(g, rank, **kw):
    return run_build(interop.graph(g), rank, device="cpu", **kw)


# ------------------------------------------------------------ flatten

def test_flatten_keys_match_jax_keystr():
    state = {"sink": {"labels_hubs": np.zeros(2), "x": {"b": np.ones(1),
                                                          "a": np.ones(2)}},
             "records": {"psi": np.zeros(3), "packed": np.zeros(4)},
             "none": None, "z": np.zeros(5)}
    want = [(jax.tree_util.keystr(p), leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(state)[0]]
    got = flatten(state)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(x is y for (_, x), (_, y) in zip(got, want))
    assert [k for k, _ in got][:2] == ["['records']['packed']",
                                       "['records']['psi']"]


def test_restore_places_leaves_like_the_template(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(6, dtype=torch.int32),
             "b": torch.tensor([1.5, 2.0], dtype=torch.bfloat16),
             "c": np.arange(3, dtype=np.int64)}
    mgr.save(1, state, data_state={"pos": 1})
    got, step, data = mgr.restore(state)
    assert step == 1 and data == {"pos": 1}
    assert torch.equal(got["a"], state["a"])
    assert got["b"].dtype == torch.bfloat16 and torch.equal(got["b"],
                                                            state["b"])
    assert isinstance(got["c"], np.ndarray) and np.array_equal(got["c"],
                                                               state["c"])


def test_async_save_snapshots_tensors_updated_in_place(tmp_path):
    """A tensor the caller updates in place after ``save`` returns (the
    sink's table, on the next insert) cannot tear the step on disk."""
    mgr = CheckpointManager(str(tmp_path))
    t = torch.zeros(1 << 16, dtype=torch.int32)
    mgr.save(1, {"t": t}, blocking=False)
    t.fill_(7)
    mgr.wait()
    got, _, _ = mgr.restore({"t": t})
    assert int(got["t"].abs().sum()) == 0


# ---------------------------------------------- resume == uninterrupted

@pytest.mark.parametrize("algo,batch,kw,keep", [
    ("plant", 8, {}, 2), ("gll", 4, {"alpha": 1.0}, 1),
    ("pll-ref", 8, {}, 3)])
def test_resume_equals_uninterrupted(tmp_path, algo, batch, kw, keep):
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    full = port_build(g, rank, algo=algo, batch=batch, ckpt=mgr, **kw)
    cursor = drop_steps_after(tmp_path, mgr, keep=keep)
    res = port_build(g, rank, algo=algo, batch=batch,
                     ckpt=CheckpointManager(str(tmp_path), keep=100),
                     resume=True, **kw)
    assert res.resumed_from == cursor
    assert tables_equal(res.sink.table(), full.sink.table())
    # counters resumed, not double-counted
    assert res.counters == full.counters
    ref = ref_run_build(g, rank, algo=algo, batch=batch, **kw)
    assert tables_equal(res.sink.table(), ref.sink.table())


@pytest.mark.parametrize("algo", ["lcc", "parapll"])
def test_single_flush_algos_resume(tmp_path, algo):
    """LCC and paraPLL commit once, at the final flush: a crash there
    leaves nothing to resume (the rerun starts fresh), and a resume
    after it restores the finished table."""
    g, rank = small()
    ref = ref_run_build(g, rank, algo=algo, batch=4)
    fplan = FaultPlan({"engine.commit": [Fault("crash")]})
    with faults(fplan):
        with pytest.raises(InjectedCrash):
            port_build(g, rank, algo=algo, batch=4,
                       ckpt=CheckpointManager(str(tmp_path)))
    assert fplan.fired == [("engine.commit", "crash")]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == []
    fresh = port_build(g, rank, algo=algo, batch=4, ckpt=mgr, resume=True)
    assert fresh.resumed_from is None
    again = port_build(g, rank, algo=algo, batch=4,
                       ckpt=CheckpointManager(str(tmp_path)), resume=True)
    assert again.resumed_from == g.n
    for res in (fresh, again):
        assert tables_equal(res.sink.table(), ref.sink.table())
        assert res.counters == ref.counters


def test_resume_rejects_other_graph_checkpoints(tmp_path):
    g1 = rg.scale_free(40, attach=2, seed=1)
    g2 = rg.scale_free(40, attach=2, seed=2)        # same n, other edges
    rank1, rank2 = degree_ranking(g1), degree_ranking(g2)
    port_build(g1, rank1, algo="plant", batch=8,
               ckpt=CheckpointManager(str(tmp_path), keep=100))
    res = port_build(g2, rank2, algo="plant", batch=8,
                     ckpt=CheckpointManager(str(tmp_path), keep=100),
                     resume=True)
    assert res.resumed_from is None                 # refused, built fresh
    validate.check_equal(lbl.to_numpy_sets(res.sink.table()),
                         pll_undirected(g2, rank2))


def test_resume_rejects_other_batch_config(tmp_path):
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    port_build(g, rank, algo="gll", batch=4, alpha=1.0, ckpt=mgr)
    drop_steps_after(tmp_path, mgr, keep=1)
    res = port_build(g, rank, algo="gll", batch=8, alpha=1.0,
                     ckpt=CheckpointManager(str(tmp_path), keep=100),
                     resume=True)
    assert res.resumed_from is None
    validate.check_equal(lbl.to_numpy_sets(res.sink.table()),
                         pll_undirected(g, rank))


def test_resume_rejects_other_algo_checkpoints(tmp_path):
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    port_build(g, rank, algo="plant", batch=8, ckpt=mgr)
    assert mgr.all_steps()
    res = port_build(g, rank, algo="gll", batch=4, alpha=1.0,
                     ckpt=CheckpointManager(str(tmp_path), keep=100),
                     resume=True)
    assert res.resumed_from is None
    validate.check_equal(lbl.to_numpy_sets(res.sink.table()),
                         pll_undirected(g, rank))


def test_regrow_resume_continues_from_committed_superstep(tmp_path):
    """A checkpoint committed under a smaller cap resumes into a grown
    sink (the restored arrays padded), not from scratch."""
    g, rank = small()
    ref = pll_undirected(g, rank)
    need = int(port_build(g, rank, algo="plant", batch=4)
               .sink.table().count.max())
    cap = None
    for c in range(3, need):
        shutil.rmtree(tmp_path, ignore_errors=True)
        os.makedirs(tmp_path)
        mgr = CheckpointManager(str(tmp_path), keep=100)
        try:
            port_build(g, rank, algo="plant", batch=4, cap=c, ckpt=mgr)
        except LabelOverflowError:
            if mgr.all_steps():
                cap = c
                break
    assert cap is not None, "no mid-run overflow cap found"
    committed = mgr.all_steps()[-1]
    assert mgr.peek()["sink"]["cap"] == cap
    res = port_build(g, rank, algo="plant", batch=4, cap=need,
                     ckpt=CheckpointManager(str(tmp_path), keep=100),
                     resume=True)
    assert res.resumed_from == committed      # continued, not restarted
    validate.check_equal(lbl.to_numpy_sets(res.sink.table()), ref)


@pytest.mark.parametrize("algo", ["plant", "gll"])
def test_build_regrow_resume_matches_reference(tmp_path, algo):
    """``build``'s regrow retry resumes from the overflowing attempt's
    checkpoints; the index, its report (``overflow_events``, records)
    and the last committed step's cap equal the reference's."""
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path / "port"), keep=100)
    idx = build(interop.graph(g), rank,
                BuildPlan(algo=algo, batch=4, cap=4, alpha=1.0),
                ckpt=mgr, device="cpu")
    rmgr = RefManager(str(tmp_path / "ref"), keep=100)
    ref = ref_build(g, rank, RefPlan(algo=algo, batch=4, cap=4, alpha=1.0),
                    ckpt=rmgr)
    assert idx.report.cap_retries >= 1
    assert ([e.to_dict() for e in idx.report.overflow_events]
            == [e.to_dict() for e in ref.report.overflow_events])
    p, r = idx.report.to_dict(), ref.report.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r
    assert tables_equal(idx.table, ref.table)
    assert mgr.peek()["sink"]["cap"] == idx.report.cap
    assert mgr.peek() == rmgr.peek()
    assert idx.validate_against(pll_undirected(g, rank))


def test_overflow_raises_before_a_checkpoint_is_saved(tmp_path):
    """A superstep whose inserts dropped labels is never committed."""
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    with pytest.raises(LabelOverflowError):
        port_build(g, rank, algo="plant", batch=40, cap=3, ckpt=mgr)
    assert mgr.all_steps() == []


# ------------------------------------------------------ cross-package

def _step_files(directory):
    """{step: (manifest, arrays)} of every committed step."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if not name.startswith("step_"):
            continue
        with open(os.path.join(directory, name, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(directory, name, "arrays.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        out[name] = (manifest, arrays)
    return out


@pytest.mark.parametrize("algo,batch,kw", [
    ("plant", 8, {}), ("gll", 4, {"alpha": 1.0}), ("lcc", 8, {}),
    ("pll-ref", 16, {})])
def test_step_manifests_and_arrays_equal_the_reference(tmp_path, algo,
                                                       batch, kw):
    g, rank = small()
    port_build(g, rank, algo=algo, batch=batch,
               ckpt=CheckpointManager(str(tmp_path / "port"), keep=100),
               **kw)
    ref_run_build(g, rank, algo=algo, batch=batch,
                  ckpt=RefManager(str(tmp_path / "ref"), keep=100), **kw)
    port, ref = _step_files(tmp_path / "port"), _step_files(tmp_path / "ref")
    assert port and list(port) == list(ref)
    for name in port:
        (pm, pa), (rm, ra) = port[name], ref[name]
        assert pm == rm, name                  # data_state key for key
        assert list(pa) == list(ra) == pm["keys"]
        for k in pa:
            assert pa[k].dtype == ra[k].dtype, k
            assert np.array_equal(pa[k], ra[k], equal_nan=True), k


@pytest.mark.parametrize("algo,batch,kw,keep", [
    ("plant", 8, {}, 2), ("gll", 4, {"alpha": 1.0}, 1)])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_resume_across_packages(tmp_path, algo, batch, kw,
                                            keep, writer):
    """A build checkpointed by one package, interrupted, resumes in the
    other to the identical table and records as the writer's own
    resume."""
    g, rank = small()
    src = tmp_path / "src"
    if writer == "reference":
        mgr = RefManager(str(src), keep=100)
        ref_run_build(g, rank, algo=algo, batch=batch, ckpt=mgr, **kw)
    else:
        mgr = CheckpointManager(str(src), keep=100)
        port_build(g, rank, algo=algo, batch=batch, ckpt=mgr, **kw)
    cursor = drop_steps_after(src, mgr, keep=keep)
    shutil.copytree(src, tmp_path / "copy")
    port = port_build(g, rank, algo=algo, batch=batch,
                      ckpt=CheckpointManager(str(src), keep=100),
                      resume=True, **kw)
    ref = ref_run_build(g, rank, algo=algo, batch=batch,
                        ckpt=RefManager(str(tmp_path / "copy"), keep=100),
                        resume=True, **kw)
    assert port.resumed_from == ref.resumed_from == cursor
    assert tables_equal(port.sink.table(), ref.sink.table())
    assert [r.to_dict() for r in port.records] == \
        [r.to_dict() for r in ref.records]
    assert port.counters == ref.counters


def test_reference_regrow_resumes_from_a_port_checkpoint(tmp_path):
    """A port build that overflowed after committing resumes in the
    reference at a grown cap, padded, to the reference's own table."""
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    with pytest.raises(LabelOverflowError):
        port_build(g, rank, algo="plant", batch=4, cap=5, ckpt=mgr)
    committed = mgr.all_steps()[-1]
    res = ref_run_build(g, rank, algo="plant", batch=4, cap=16,
                        ckpt=RefManager(str(tmp_path), keep=100),
                        resume=True)
    assert res.resumed_from == committed
    want = ref_run_build(g, rank, algo="plant", batch=4, cap=16)
    assert tables_equal(res.sink.table(), want.sink.table())
    with pytest.raises(RefOverflow):
        ref_run_build(g, rank, algo="plant", batch=4, cap=5)
