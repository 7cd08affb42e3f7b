"""The port's dynamic repair against the reference's ``test_dynamic.py``
(its dense cases) and against the reference package itself.

Typed mutation batches (validation, ``resolve``, ``apply`` through the
port's ``from_edges``: graph arrays byte-identical to the reference's),
the affected frontier (endpoint planes equal to Dijkstra, the affected
set sound against a label diff and equal to the reference's), repair
bit-identical to a from-scratch rebuild on the mutated graph and to the
reference's repair (arrays, ``RepairReport`` counts, ``store_fingerprint``),
repair checkpoints isolated by kind and resumable, and the serving
invalidation chain. Weights are integral f32: every comparison is
exact.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import repro.dynamic as rd
import repro.graphs as rg
from repro.core.pll import pll_undirected
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro.sssp.oracle import dijkstra
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.dynamic import (EdgeDelete, EdgeInsert, EdgeReweight,
                                 MutationBatch, RepairPolicy, RepairReport,
                                 affected_hubs, endpoint_planes,
                                 random_mutations, store_fingerprint)
from repro_torch.engine.runner import run
from repro_torch.engine.sink import DenseSink
from repro_torch.graphs import Graph
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.serve import AnswerCache

torch.set_num_threads(1)


def road():
    g = rg.grid_road(8, 8, seed=2)          # many tied shortest paths
    return interop.graph(g), degree_ranking(g)


def sf():
    g = rg.scale_free(96, attach=2, seed=1)
    return interop.graph(g), degree_ranking(g)


def ref_graph(g) -> rg.Graph:
    """The reference package's Graph of the port graph's arcs: its CSR
    through the reference's ``from_edges``, as ``load_npz`` rebuilds a
    graph."""
    src = np.repeat(np.arange(g.n, dtype=np.int32),
                    np.diff(g.indptr).astype(np.int64))
    return rg.from_edges(g.n, src, g.indices, g.weights,
                         directed=g.directed)


def ref_batch(batch: MutationBatch) -> rd.MutationBatch:
    return rd.MutationBatch.from_dict(batch.to_dict())


def port_build(g, rank, **kw):
    return build(g, rank, BuildPlan(**kw), device="cpu")


def fresh_view(idx: CHLIndex) -> CHLIndex:
    """Pre-mutation view sharing the label tensors; apply() swaps the
    store object, never writes into its tensors."""
    return CHLIndex(idx.store, plan=idx.plan, report=idx.report,
                    rank=idx.rank)


def stores_equal(a, b) -> bool:
    """Raw bit-identity shard by shard (slot order and padding
    included), for a port store against a port or reference store."""
    sa, sb = list(a.shard_arrays()), list(b.shard_arrays())
    if [k for k, _ in sa] != [k for k, _ in sb]:
        return False
    return all(np.array_equal(np.asarray(x[key]), np.asarray(y[key]))
               for (_, x), (_, y) in zip(sa, sb)
               for key in ("hubs", "dist", "count"))


def assert_repair_matches_rebuild(g, rank, batch, *, algo="plant"):
    """apply() on an index built with ``algo`` leaves exactly the
    arrays of a from-scratch PLaNT build on the mutated graph (at the
    repaired cap), and of the reference's repair of its own index."""
    idx = port_build(g, rank, algo=algo, batch=8)
    rep = idx.apply(batch, graph=g)
    g_new = batch.apply(g)
    again = port_build(g_new, rank, algo="plant", batch=8, cap=rep.cap)
    assert stores_equal(idx.store, again.store), \
        "repaired store diverges from a from-scratch rebuild"
    idx.validate_against(g_new)          # cover property on the new graph
    ref = ref_build(ref_graph(g), rank, RefPlan(algo=algo, batch=8))
    ref_rep = ref.apply(ref_batch(batch), graph=ref_graph(g))
    assert stores_equal(idx.store, ref.store)
    assert store_fingerprint(idx.store) == rd.store_fingerprint(ref.store)
    p, r = rep.to_dict(), ref_rep.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r                        # counts, cap, records
    return idx, rep, g_new


def _an_edge(g):
    src = np.repeat(np.arange(g.n), np.diff(g.indptr))
    for u, v in zip(src, g.indices):
        if u < v:
            return int(u), int(v)
    raise AssertionError("no edge")


def _a_non_edge(g):
    nbrs = set(int(x) for x in g.indices[g.indptr[0]:g.indptr[1]])
    for b in range(g.n - 1, 0, -1):
        if b not in nbrs:
            return 0, b
    raise AssertionError("vertex 0 is adjacent to everything")


# ----------------------------------------------------- mutation batch

def test_batch_structural_validation():
    with pytest.raises(ValueError, match="self-loop"):
        MutationBatch([EdgeDelete(3, 3)])
    with pytest.raises(ValueError, match="negative"):
        MutationBatch([EdgeInsert(-1, 2, 1.0)])
    with pytest.raises(ValueError, match="edge-disjoint"):
        MutationBatch([EdgeDelete(1, 2), EdgeReweight(2, 1, 5.0)])
    with pytest.raises(ValueError, match="finite and positive"):
        MutationBatch([EdgeInsert(0, 1, 0.0)])
    with pytest.raises(ValueError, match="finite and positive"):
        MutationBatch([EdgeReweight(0, 1, float("inf"))])
    with pytest.raises(TypeError):
        MutationBatch([(0, 1, 2.0)])


def test_resolve_validates_against_graph():
    g, _ = road()
    with pytest.raises(ValueError, match="out of range"):
        MutationBatch([EdgeDelete(0, g.n)]).resolve(g)
    with pytest.raises(ValueError, match="use EdgeReweight"):
        MutationBatch([EdgeInsert(0, 1, 2.0)]).resolve(g)  # a grid edge
    with pytest.raises(ValueError, match="missing edge"):
        MutationBatch([EdgeDelete(0, g.n - 1)]).resolve(g)
    with pytest.raises(ValueError, match="missing edge"):
        MutationBatch([EdgeReweight(0, g.n - 1, 2.0)]).resolve(g)
    gd = interop.graph(rg.random_connected(16, extra_edges=10, seed=0,
                                           directed=True))
    # the reference's refusal, word for word
    with pytest.raises(NotImplementedError,
                       match=r"supports undirected graphs \(directed "
                             r"repair is a ROADMAP item\)"):
        MutationBatch([EdgeDelete(0, 1)]).resolve(gd)
    with pytest.raises(NotImplementedError, match="undirected") as ref_err:
        rd.MutationBatch([rd.EdgeDelete(0, 1)]).resolve(ref_graph(gd))
    with pytest.raises(NotImplementedError) as port_err:
        MutationBatch([EdgeDelete(0, 1)]).resolve(gd)
    assert str(port_err.value) == str(ref_err.value)


def test_apply_and_resolve_equal_the_reference():
    g, _ = road()
    batch = MutationBatch([EdgeDelete(0, 1), EdgeReweight(0, 8, 7.0),
                           EdgeInsert(0, 63, 3.0)])
    rb, want = batch.resolve(g), ref_batch(batch).resolve(ref_graph(g))
    for f in ("u", "v", "kind", "w_old", "w_new"):
        got, exp = getattr(rb, f), getattr(want, f)
        assert got.dtype == exp.dtype
        assert np.array_equal(got, exp, equal_nan=True), f
    g2 = batch.apply(g)
    r2 = interop.graph(ref_batch(batch).apply(ref_graph(g)))
    for f in dataclasses.fields(Graph):
        a, b = getattr(g2, f.name), getattr(r2, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    d0 = endpoint_planes(g2, [0], device="cpu")[0]
    assert d0[63] == np.float32(3.0)          # the inserted shortcut
    assert d0[1] > np.float32(1.0)            # 0-1 gone (>= 2 hops)
    rb2 = MutationBatch([EdgeReweight(0, 8, 5.0)]).resolve(g2)
    assert rb2.w_old[0] == np.float32(7.0)
    assert batch.counts == {"insert": 1, "delete": 1, "reweight": 1}
    np.testing.assert_array_equal(batch.touched(), [0, 1, 8, 63])
    assert batch.fingerprint() == ref_batch(batch).fingerprint()
    assert batch.fingerprint() == MutationBatch(list(batch)).fingerprint()
    assert MutationBatch.from_dict(batch.to_dict()).to_dict() == \
        batch.to_dict()


def test_random_mutations_equal_the_reference():
    g, _ = sf()
    batch = random_mutations(g, np.random.default_rng(0), inserts=3,
                             deletes=3, reweights=3)
    want = rd.random_mutations(ref_graph(g), np.random.default_rng(0),
                               inserts=3, deletes=3, reweights=3)
    assert batch.to_dict() == want.to_dict()
    assert batch.counts == {"insert": 3, "delete": 3, "reweight": 3}
    assert batch.apply(g).n == g.n


# ------------------------------------------------- affected frontier

def test_endpoint_planes_match_oracle_and_reference():
    g, _ = road()
    planes = endpoint_planes(g, [0, 17, 63, 5, 9], chunk=2,
                             device="cpu")                  # 3 chunks
    want = rd.endpoint_planes(ref_graph(g), [0, 17, 63, 5, 9], chunk=2)
    assert sorted(planes) == sorted(want)
    for r, row in planes.items():
        assert row.dtype == np.float32
        np.testing.assert_array_equal(row, want[r])
        np.testing.assert_array_equal(row,
                                      dijkstra(g, r).astype(np.float32))


@pytest.mark.parametrize("seed", [3, 4])
def test_affected_hubs_sound_and_equal_the_reference(seed):
    """Every hub whose labels differ between the builds on g and on the
    mutated graph is flagged (the test may overapproximate, never miss
    a changed tree), and the set equals the reference's."""
    g, rank = road()
    batch = random_mutations(g, np.random.default_rng(seed), inserts=1,
                             deletes=1, reweights=1)
    g2 = batch.apply(g)
    got = affected_hubs(g, g2, batch.resolve(g), device="cpu")
    rb = ref_batch(batch)
    want = rd.affected_hubs(ref_graph(g), rb.apply(ref_graph(g)),
                            rb.resolve(ref_graph(g)))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    affected = set(got.tolist())
    old, new = pll_undirected(g, rank), pll_undirected(g2, rank)
    changed = set()
    for row_o, row_n in zip(old, new):
        for item in set(row_o.items()) ^ set(row_n.items()):
            changed.add(item[0])
    assert changed <= affected, \
        f"missed affected trees: {sorted(changed - affected)[:5]}"
    assert 0 < len(affected) < g.n       # and a strict subset


def test_empty_batch_is_noop():
    g, rank = sf()
    idx = port_build(g, rank, algo="plant", batch=8)
    before = idx.store
    rep = idx.apply(MutationBatch([]), graph=g)
    assert rep.affected == rep.invalidated == rep.repaired == 0
    assert stores_equal(idx.store, before)


# ---------------------------------------- bit-identical repair (dense)

def test_repair_delete_bit_identical_dense():
    g, rank = road()
    assert_repair_matches_rebuild(g, rank,
                                  MutationBatch([EdgeDelete(27, 28)]))


def test_repair_insert_bit_identical_dense():
    g, rank = road()
    assert_repair_matches_rebuild(g, rank,
                                  MutationBatch([EdgeInsert(0, 63, 2.0)]))


def test_repair_reweight_ties_bit_identical_dense():
    """A reweight that re-ties paths on the grid: the ``<=`` side of the
    affected test keeps max-rank tie-breaking intact."""
    g, rank = road()
    assert_repair_matches_rebuild(
        g, rank, MutationBatch([EdgeReweight(27, 28, 2.0)]))


def test_repair_mixed_batch_bit_identical_dense():
    g, rank = sf()
    batch = random_mutations(g, np.random.default_rng(7), inserts=2,
                             deletes=2, reweights=2)
    idx, rep, g_new = assert_repair_matches_rebuild(g, rank, batch)
    assert rep.store == "dense" and rep.cap == idx.table.cap
    assert rep.total_labels == idx.total_labels
    assert rep.affected >= rep.mutations["delete"]
    idx.validate_against(pll_undirected(g_new, rank))   # the exact CHL


@pytest.mark.parametrize("algo", ["gll", "lcc", "pll-ref"])
def test_repair_of_other_algos_bit_identical(algo):
    """The CHL is algorithm-independent and the merge re-sorts every
    row into schedule order, so apply() on a GLL/LCC/pll-ref index
    lands on the canonical arrays too."""
    g, rank = sf()
    assert_repair_matches_rebuild(
        g, rank, MutationBatch([EdgeDelete(*_an_edge(g))]), algo=algo)


def test_repair_regrows_the_cap_like_the_reference():
    """A tight cap that the repaired rows outgrow is regrown by the
    build's rule (`plan.cap_growth`), as the reference does."""
    g, rank = sf()
    tight = int(port_build(g, rank, algo="plant", batch=8)
                .table.count.max())
    idx = port_build(g, rank, algo="plant", batch=8, cap=tight)
    ref = ref_build(ref_graph(g), rank, RefPlan(algo="plant", batch=8,
                                                cap=tight))
    batch = MutationBatch([EdgeInsert(*_a_non_edge(g), 1.0)])
    rep = idx.apply(batch, graph=g)
    ref_rep = ref.apply(ref_batch(batch), graph=ref_graph(g))
    assert rep.cap == ref_rep.cap
    assert stores_equal(idx.store, ref.store)


# ------------------------------------------------ report & rejection

def test_repair_report_round_trip():
    g, rank = sf()
    idx = port_build(g, rank, algo="plant", batch=8)
    # a weight-1 insert between non-adjacent vertices shortens d(u, v)
    rep = idx.apply(MutationBatch([EdgeInsert(*_a_non_edge(g), 1.0)]),
                    graph=g)
    assert rep.waves == len(rep.supersteps) > 0
    assert rep.wall_s > 0 and rep.als > 0
    d = rep.to_dict()
    assert RepairReport.from_dict(d).to_dict() == d
    s = rep.summary()
    assert "affected=" in s and "invalidated=" in s


def test_apply_rejects_wrong_graph_size():
    g, rank = sf()
    idx = port_build(g, rank, algo="plant", batch=8)
    g_other = interop.graph(rg.scale_free(97, attach=2, seed=1))
    with pytest.raises(ValueError, match="n="):
        idx.apply(MutationBatch([]), graph=g_other)


# ------------------------------------------- checkpoint kind safety

def _repair_fixture():
    g, rank = road()
    batch = MutationBatch([EdgeDelete(27, 28)])
    g2 = batch.apply(g)
    roots = affected_hubs(g, g2, batch.resolve(g), device="cpu")
    return g2, rank, np.sort(roots)


def test_repair_checkpoints_refused_by_build_kind(tmp_path):
    """A lookalike policy with the same name, config and fingerprint but
    ``kind="build"`` does not adopt committed repair states; a true
    repair resume does."""
    g2, rank, roots = _repair_fixture()

    def make(cls):
        return cls(g2, rank, batch=8, device="cpu", roots_order=roots)

    mgr = CheckpointManager(str(tmp_path), keep=100)
    full = run(make(RepairPolicy), DenseSink(g2.n, 64, "cpu"), ckpt=mgr)
    assert len(mgr.all_steps()) > 0
    assert mgr.peek()["kind"] == "repair" and mgr.peek()["algo"] == "repair"
    res2 = run(make(RepairPolicy), DenseSink(g2.n, 64, "cpu"),
               ckpt=CheckpointManager(str(tmp_path), keep=100), resume=True)
    assert res2.resumed_from is not None          # same kind restores
    assert all(torch.equal(a, b) for a, b in zip(res2.sink.table(),
                                                 full.sink.table()))

    class BuildKindLookalike(RepairPolicy):
        kind = "build"                   # name and fingerprint unchanged

    res = run(make(BuildKindLookalike), DenseSink(g2.n, 64, "cpu"),
              ckpt=CheckpointManager(str(tmp_path), keep=100), resume=True)
    assert res.resumed_from is None               # refused: cross-kind


def test_repair_resume_equality(tmp_path):
    """An interrupted repair resumed mid-wave lands on the arrays of an
    uninterrupted one."""
    g, rank = road()
    idx = port_build(g, rank, algo="plant", batch=8)
    batch = random_mutations(g, np.random.default_rng(11), deletes=1,
                             reweights=1)
    a = fresh_view(idx)
    a.apply(batch, graph=g)              # uninterrupted
    b = fresh_view(idx)
    mgr = CheckpointManager(str(tmp_path), keep=100)
    b.apply(batch, graph=g, ckpt=mgr)
    steps = mgr.all_steps()
    assert len(steps) > 1
    for s in steps[1:]:                  # simulate an interrupt
        shutil.rmtree(os.path.join(str(tmp_path), f"step_{s:010d}"))
    c = fresh_view(idx)
    rep = c.apply(batch, graph=g,
                  ckpt=CheckpointManager(str(tmp_path), keep=100),
                  resume=True)
    assert rep.resumed_from == steps[0]
    assert stores_equal(c.store, a.store)
    assert stores_equal(b.store, a.store)


# --------------------------------------------- serving invalidation

def test_answer_cache_epoch_invalidation():
    c = AnswerCache(8, symmetric=True)
    c.put(1, 2, 3.0)
    assert c.get(2, 1) == np.float32(3.0)
    c.invalidate()
    assert c.get(1, 2) is None           # stale entry rejected
    c.put(1, 2, 4.0)
    assert c.get(1, 2) == np.float32(4.0)


def test_apply_invalidates_live_services():
    """serve -> mutate -> the service already handed out answers from
    the repaired labels with a cold cache."""
    g, rank = sf()
    idx = port_build(g, rank, algo="plant", batch=8)
    svc = idx.serve(mode="qlsn", batch_size=32, cache=64)
    rng = np.random.default_rng(2)
    u, v = rng.integers(0, g.n, 48), rng.integers(0, g.n, 48)
    svc.submit(u, v)
    stale = svc.flush()
    batch = random_mutations(g, np.random.default_rng(13), deletes=1,
                             reweights=1)
    idx.apply(batch, graph=g)
    assert svc.stats_.invalidations == 1
    svc.submit(u, v)
    fresh = svc.flush()
    np.testing.assert_array_equal(fresh, idx.query(u, v))
    assert not np.array_equal(stale, fresh)  # the answers moved
    g_new = batch.apply(g)
    want = np.array([dijkstra(g_new, int(a))[int(b)] for a, b in zip(u, v)],
                    np.float32)
    np.testing.assert_array_equal(fresh, want)


def test_dead_services_are_pruned():
    g, rank = sf()
    idx = port_build(g, rank, algo="plant", batch=8)
    keep = idx.serve(cache=8)
    idx.serve(cache=8)                   # dropped at once
    import gc
    gc.collect()
    idx.apply(MutationBatch([EdgeDelete(*_an_edge(g))]), graph=g)
    assert len(idx._services) == 1 and idx._services[0][0]() is keep
    assert keep.stats_.invalidations == 1
