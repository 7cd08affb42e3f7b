"""Directed builds and their queries in the port, against the reference.

Mirrors the reference's ``tests/test_directed.py`` (every case), the
directed cases of ``test_index.py``, ``test_engine.py`` and
``test_dynamic.py``, and holds the port's arrays against the
reference's on the same numpy inputs: ``Graph.reverse`` byte for byte
(duplicate and tied arcs too), the directed oracle and PLL label sets,
the ``L_out``/``L_in`` tables (slot order and padding), records and
report, ``query_directed`` answers and witness hubs, artifacts and
checkpoints that cross the packages both ways. Weights are integral
f32: every comparison is exact.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as rg
from repro.checkpoint import CheckpointManager as RefManager
from repro.core import pll as ref_pll
from repro.core.directed import query_directed as ref_query_directed
from repro.engine import run_build as ref_run_build
from repro.graphs.ranking import degree_ranking, random_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import CHLIndex as RefIndex
from repro.index import build as ref_build
from repro.sssp import oracle as ref_oracle
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import labels as lbl
from repro_torch.core import pll
from repro_torch.core.directed import plant_directed_chl, query_directed
from repro_torch.dynamic import EdgeDelete, MutationBatch
from repro_torch.engine import run_build
from repro_torch.engine.sink import DenseSink
from repro_torch.graphs import from_edges
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.kernels.label_query import (label_query_pair_rows,
                                             label_query_ref,
                                             query_table_pair)
from repro_torch.sssp import oracle
from repro_torch.sssp.oracle import dijkstra

torch.set_num_threads(1)

GRAPH_FIELDS = ("ell_src", "ell_w", "ell_dst", "ell_w_out", "indptr",
                "indices", "weights")

#: the five graphs of the reference's test_directed.py: three cover
#: cases (random ranking) and two PLL-equality cases (degree ranking)
CASES = [("cover", 0), ("cover", 1), ("cover", 2), ("pll", 0), ("pll", 1)]


def case(kind, seed):
    """(reference graph, rank, batch) of one test_directed.py case."""
    if kind == "cover":
        g = rg.random_connected(28, extra_edges=50, seed=seed, directed=True)
        return g, random_ranking(g.n, seed=seed + 9), 8
    g = rg.random_connected(24, extra_edges=40, seed=seed, directed=True)
    return g, degree_ranking(g), 4


def small():
    g = rg.random_connected(24, extra_edges=40, seed=0, directed=True)
    return g, degree_ranking(g)


def tables_equal(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(a, b))


def all_pairs_ids(n):
    return (np.repeat(np.arange(n), n).astype(np.int64),
            np.tile(np.arange(n), n).astype(np.int64))


def port_run(g, rank, **kw):
    return run_build(interop.graph(g), rank, algo="directed", device="cpu",
                     **kw)


def drop_steps_after(tmp, mgr, keep: int) -> int:
    steps = mgr.all_steps()
    assert len(steps) > keep, "scenario needs a later checkpoint to drop"
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(str(tmp), f"step_{s:010d}"))
    return steps[keep - 1]


# ------------------------------------------------------ Graph.reverse

@pytest.mark.parametrize("make", [
    lambda: rg.random_connected(40, extra_edges=90, seed=3, directed=True),
    lambda: rg.random_connected(48, extra_edges=200, seed=5, max_w=2,
                                directed=True),                 # ties
    lambda: rg.random_connected(300, extra_edges=900, seed=8,
                                directed=True),
    lambda: rg.from_edges(                          # duplicate arcs
        6, np.array([0, 0, 0, 1, 2, 2, 5, 5, 3]),
        np.array([1, 1, 2, 2, 0, 0, 4, 4, 5]),
        np.array([3, 1, 2, 2, 7, 7, 1, 4, 9], np.float32),
        directed=True),
], ids=["random", "tie-heavy", "wider", "duplicates"])
def test_reverse_byte_identical(make):
    g = make()
    got, want = interop.graph(g).reverse(), g.reverse()
    assert got.n == want.n and got.m == want.m and got.directed
    for f in GRAPH_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    # reversing twice gives the graph back
    twice = interop.graph(g).reverse().reverse()
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(twice, f), getattr(g, f)), f


def test_reverse_of_undirected_is_itself():
    pg = interop.graph(rg.grid_road(4, 4, seed=1))
    assert pg.reverse() is pg


def test_reverse_of_from_edges_with_duplicates_equals_reference():
    # the port's packed arc sort against the reference's lexsort, on
    # arcs that tie in key and weight
    rng = np.random.default_rng(4)
    src = rng.integers(0, 30, 400)
    dst = rng.integers(0, 30, 400)
    w = rng.integers(1, 4, 400).astype(np.float32)
    got = from_edges(30, src, dst, w, directed=True).reverse()
    want = rg.from_edges(30, src, dst, w, directed=True).reverse()
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# ------------------------------------------------ oracles and the PLL

@pytest.mark.parametrize("kind,seed", CASES)
def test_directed_oracles_equal_reference(kind, seed):
    g, rank, _ = case(kind, seed)
    pg = interop.graph(g)
    for root in (0, g.n // 2, g.n - 1):
        d, m = oracle.dijkstra_maxrank(pg, root, rank)
        rd, rm = ref_oracle.dijkstra_maxrank(g, root, rank)
        assert np.array_equal(d, rd) and np.array_equal(m, rm)
    l_out, l_in = pll.pll_directed(pg, rank)
    r_out, r_in = ref_pll.pll_directed(g, rank)
    assert l_out == r_out and l_in == r_in
    for u, v in ((0, 1), (3, g.n - 1), (g.n - 1, 0)):
        assert pll.query_distance_directed(l_out, l_in, u, v) == \
            ref_pll.query_distance_directed(r_out, r_in, u, v)


# ------------------------------------------- test_directed.py, ported

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_directed_plant_cover(seed):
    g, rank, batch = case("cover", seed)
    pg = interop.graph(g)
    l_out, l_in = plant_directed_chl(pg, rank, batch=batch, device="cpu")
    D = np.stack([dijkstra(pg, v) for v in range(g.n)])
    u, v = all_pairs_ids(g.n)
    got = query_directed(l_out, l_in, torch.as_tensor(u),
                         torch.as_tensor(v)).numpy().reshape(g.n, g.n)
    finite = np.isfinite(D)
    np.testing.assert_array_equal(got[finite], D[finite].astype(np.float32))
    assert not np.isfinite(got[~finite]).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_directed_plant_equals_pll(seed):
    g, rank, batch = case("pll", seed)
    pg = interop.graph(g)
    ref_out, ref_in = pll.pll_directed(pg, rank)
    l_out, l_in = plant_directed_chl(pg, rank, batch=batch, device="cpu")
    got_out, got_in = lbl.to_numpy_sets(l_out), lbl.to_numpy_sets(l_in)
    for v in range(g.n):
        assert got_out[v] == ref_out[v], (v, got_out[v], ref_out[v])
        assert got_in[v] == ref_in[v], (v, got_in[v], ref_in[v])


# --------------------------------------- the build against the reference

@pytest.mark.parametrize("kind,seed", CASES)
def test_directed_build_equals_reference(kind, seed):
    """Tables (slot order, padding), records, report and every pair's
    answer and witness hub equal the reference's."""
    g, rank, batch = case(kind, seed)
    port = build(interop.graph(g), rank,
                 BuildPlan(algo="directed", batch=batch), device="cpu")
    ref = ref_build(g, rank, RefPlan(algo="directed", batch=batch))
    assert port.directed and ref.directed
    assert tables_equal(port.l_out, ref.l_out)
    assert tables_equal(port.l_in, ref.l_in)
    p, r = port.report.to_dict(), ref.report.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r
    assert (port.n, port.total_labels, port.als) == \
        (ref.n, ref.total_labels, ref.als)
    u, v = all_pairs_ids(g.n)
    d, h = port.query_with_hub(u, v)
    rd, rh = ref.query_with_hub(u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(d, rd) and np.array_equal(h, rh)
    # the engine entry point: the same tables through query_directed
    rd2, rh2 = ref_query_directed(ref.l_out, ref.l_in, jnp.asarray(u),
                                  jnp.asarray(v), with_hub=True)
    d2, h2 = query_directed(port.l_out, port.l_in, torch.as_tensor(u),
                            torch.as_tensor(v), with_hub=True)
    assert np.array_equal(d2.numpy(), np.asarray(rd2))
    assert np.array_equal(h2.numpy(), np.asarray(rh2))
    assert port.memory_report() == ref.memory_report()


def test_build_directed_facade():
    g, rank = small()
    pg = interop.graph(g)
    idx = build(pg, rank, BuildPlan(algo="directed", batch=8),
                device="cpu")
    assert idx.directed and idx.table is None
    assert idx.validate_against(pg)
    assert idx.validate_against(pll.pll_directed(pg, rank))


def test_build_rejects_wrong_directedness():
    g = interop.graph(rg.scale_free(40, attach=2, seed=1))
    with pytest.raises(ValueError, match="directed graph"):
        build(g, degree_ranking(g), BuildPlan(algo="directed"),
              device="cpu")
    gd = interop.graph(rg.random_connected(12, extra_edges=10, seed=0,
                                           directed=True))
    with pytest.raises(ValueError, match="undirected"):
        build(gd, degree_ranking(gd), BuildPlan(algo="plant"), device="cpu")
    with pytest.raises(ValueError, match="dense"):
        build(gd, degree_ranking(gd),
              BuildPlan(algo="directed", store="sharded"), device="cpu")
    with pytest.raises(ValueError, match="directed graph"):
        plant_directed_chl(g, degree_ranking(g), device="cpu")


def test_index_constructor_checks():
    g, rank = small()
    idx = build(interop.graph(g), rank, BuildPlan(algo="directed", batch=8),
                device="cpu")
    kw = dict(plan=idx.plan, report=idx.report, rank=rank)
    with pytest.raises(ValueError, match="exactly one"):
        CHLIndex(**kw)
    with pytest.raises(ValueError, match="both l_out and l_in"):
        CHLIndex(l_out=idx.l_out, **kw)
    broken = idx.l_in._replace(dist=idx.l_in.dist.clone())
    broken.dist[0, -1] = 1.0                  # a finite slot past the count
    with pytest.raises(ValueError, match="padding"):
        CHLIndex(l_out=idx.l_out, l_in=broken, **kw)


# ---------------------------------------------------- sink and serving

def test_dense_sink_channels_equal_reference():
    from repro.engine.sink import DenseSink as RefSink
    port = DenseSink(5, 3, "cpu", channels=("out", "in"))
    ref = RefSink(5, 3, channels=("out", "in"))
    assert port.meta() == ref.meta()
    pa, ra = port.state_arrays(), ref.state_arrays()
    assert sorted(pa) == sorted(ra) == [
        "in_count", "in_dist", "in_hubs", "out_count", "out_dist",
        "out_hubs"]
    roots = np.array([2, 4])
    emit = np.zeros((2, 5), bool)
    emit[0, [0, 1, 2]] = emit[1, [1, 3]] = True
    dist = np.arange(10, dtype=np.float32).reshape(2, 5)
    for _ in range(2):                       # the second insert overflows
        port.insert(torch.as_tensor(roots), torch.as_tensor(emit),
                    torch.as_tensor(dist), channel="in")
        ref.insert(jnp.asarray(roots), jnp.asarray(emit), jnp.asarray(dist),
                   channel="in")
    assert port.overflowed() == ref.overflowed() is True
    for k, v in port.state_arrays().items():
        assert np.array_equal(v.numpy(), np.asarray(ref.state_arrays()[k]))


def test_serve_cache_symmetry_follows_directedness():
    sg = interop.graph(rg.scale_free(96, attach=2, seed=1))
    idx = build(sg, degree_ranking(sg), BuildPlan(algo="plant", batch=8),
                device="cpu")
    assert idx.serve(cache=8)._cache.symmetric is True
    g, rank = small()
    idxd = build(interop.graph(g), rank, BuildPlan(algo="directed", batch=8),
                 device="cpu")
    svcd = idxd.serve(mode="qlsn", batch_size=16, cache=8)
    assert svcd._cache.symmetric is False
    rng = np.random.default_rng(4)
    u, v = rng.integers(0, g.n, 32), rng.integers(0, g.n, 32)
    svcd.submit(u, v)
    np.testing.assert_array_equal(svcd.flush(), idxd.query(u, v))
    # d(u->v) and d(v->u) are served apart, also from the cache
    svcd.submit(v, u)
    np.testing.assert_array_equal(svcd.flush(), idxd.query(v, u))
    assert not np.array_equal(idxd.query(u, v), idxd.query(v, u))
    with pytest.raises(NotImplementedError, match="qlsn"):
        idxd.serve(mode="qfdl")


def test_apply_rejects_directed_like_reference():
    g, rank = small()
    pg = interop.graph(g)
    idx = build(pg, rank, BuildPlan(algo="directed", batch=8), device="cpu")
    with pytest.raises(NotImplementedError) as port_err:
        idx.apply(MutationBatch([EdgeDelete(0, 1)]), graph=pg)
    from repro.dynamic import EdgeDelete as RefDelete
    from repro.dynamic import MutationBatch as RefBatch
    ref = ref_build(g, rank, RefPlan(algo="directed", batch=8))
    with pytest.raises(NotImplementedError) as ref_err:
        ref.apply(RefBatch([RefDelete(0, 1)]), graph=g)
    assert str(port_err.value) == str(ref_err.value)
    assert "undirected" in str(port_err.value)


# ---------------------------------------------------------- artifacts

def test_save_load_round_trip_directed(tmp_path):
    g = rg.random_connected(20, extra_edges=30, seed=1, directed=True)
    rank = random_ranking(g.n, seed=2)
    pg = interop.graph(g)
    idx = build(pg, rank, BuildPlan(algo="directed", batch=4), device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    idx2 = CHLIndex.load(path, rank=rank, device="cpu")
    assert idx2.directed
    assert tables_equal(idx2.l_out, idx.l_out)
    assert tables_equal(idx2.l_in, idx.l_in)
    assert idx2.validate_against(pg)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["directed"] is True
    assert manifest["store"]["kind"] == "dense"
    assert manifest["store"]["shard_labels"] == [idx.total_labels]
    with pytest.raises(NotImplementedError, match="dense residency"):
        CHLIndex.load(path, store="sharded", device="cpu")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directed_artifacts_cross_packages(tmp_path, writer):
    g, rank = small()
    port = build(interop.graph(g), rank, BuildPlan(algo="directed", batch=4),
                 device="cpu")
    ref = ref_build(g, rank, RefPlan(algo="directed", batch=4))
    if writer == "reference":
        path = ref.save(str(tmp_path / "idx"))
        loaded = CHLIndex.load(path, rank=rank, device="cpu")
        want = port
    else:
        path = port.save(str(tmp_path / "idx"))
        loaded = RefIndex.load(path, rank=rank)
        want = ref
    assert loaded.directed
    assert tables_equal(loaded.l_out, want.l_out)
    assert tables_equal(loaded.l_in, want.l_in)
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert sorted(z.files) == ["in_count", "in_dist", "in_hubs",
                                   "out_count", "out_dist", "out_hubs"]
    u, v = all_pairs_ids(g.n)
    assert np.array_equal(np.asarray(loaded.query(u, v)),
                          np.asarray(want.query(u, v)))


# --------------------------------------------------------- checkpoints

def test_directed_resume_equality(tmp_path):
    g, rank = small()
    mgr = CheckpointManager(str(tmp_path), keep=100)
    full = port_run(g, rank, batch=4, ckpt=mgr)
    cursor = drop_steps_after(tmp_path, mgr, keep=2)
    res = port_run(g, rank, batch=4,
                   ckpt=CheckpointManager(str(tmp_path), keep=100),
                   resume=True)
    assert res.resumed_from == cursor
    assert tables_equal(res.sink.table("out"), full.sink.table("out"))
    assert tables_equal(res.sink.table("in"), full.sink.table("in"))
    # records restored from a step carry psi as f32, as in the reference
    def rows(records):
        return [dict(r.to_dict(), psi=None) for r in records]
    assert rows(res.records) == rows(full.records)


def test_directed_step_files_equal_reference(tmp_path):
    g, rank = small()
    port_run(g, rank, batch=8,
             ckpt=CheckpointManager(str(tmp_path / "port"), keep=100))
    ref_run_build(g, rank, algo="directed", batch=8,
                  ckpt=RefManager(str(tmp_path / "ref"), keep=100))
    names = sorted(os.listdir(tmp_path / "port"))
    assert names and names == sorted(os.listdir(tmp_path / "ref"))
    for name in names:
        if not name.startswith("step_"):
            continue
        files = []
        for side in ("port", "ref"):
            d = tmp_path / side / name
            with open(d / "manifest.json") as f:
                manifest = json.load(f)
            with np.load(d / "arrays.npz") as z:
                files.append((manifest, {k: z[k] for k in z.files}))
        (pm, pa), (rm, ra) = files
        assert pm == rm, name
        assert pm["data_state"]["sink"]["channels"] == ["out", "in"]
        assert list(pa) == list(ra)
        for k in pa:
            assert pa[k].dtype == ra[k].dtype, k
            assert np.array_equal(pa[k], ra[k], equal_nan=True), k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directed_checkpoints_resume_across_packages(tmp_path, writer):
    g, rank = small()
    src = tmp_path / "src"
    if writer == "reference":
        mgr = RefManager(str(src), keep=100)
        ref_run_build(g, rank, algo="directed", batch=4, ckpt=mgr)
    else:
        mgr = CheckpointManager(str(src), keep=100)
        port_run(g, rank, batch=4, ckpt=mgr)
    cursor = drop_steps_after(src, mgr, keep=2)
    shutil.copytree(src, tmp_path / "copy")
    port = port_run(g, rank, batch=4,
                    ckpt=CheckpointManager(str(src), keep=100), resume=True)
    ref = ref_run_build(g, rank, algo="directed", batch=4,
                        ckpt=RefManager(str(tmp_path / "copy"), keep=100),
                        resume=True)
    assert port.resumed_from == ref.resumed_from == cursor
    for ch in ("out", "in"):
        assert tables_equal(port.sink.table(ch), ref.sink.table(ch))
    assert [r.to_dict() for r in port.records] == \
        [r.to_dict() for r in ref.records]


# ------------------------------------------------------ the two-table query

def test_query_table_pair_on_the_cpu_is_the_plain_version():
    rng = np.random.default_rng(2)
    n, L, Q = 50, 6, 300
    tabs = []
    for _ in range(2):
        count = rng.integers(0, L + 1, n).astype(np.int32)
        hubs = rng.integers(0, 12, (n, L)).astype(np.int32)
        dist = rng.integers(0, 9, (n, L)).astype(np.float32)
        past = np.arange(L)[None, :] >= count[:, None]
        hubs[past], dist[past] = -1, np.inf
        tabs.append(interop.label_table(hubs, dist, count, "cpu"))
    u = torch.as_tensor(rng.integers(-n, n, Q))       # negative ids wrap
    v = torch.as_tensor(rng.integers(-n, n, Q))
    d, h = query_table_pair(tabs[0], tabs[1], u, v)
    pd, ph = label_query_ref(tabs[0].hubs[u], tabs[0].dist[u],
                             tabs[1].hubs[v], tabs[1].dist[v])
    assert torch.equal(d, pd) and torch.equal(h, ph)
    # the reference's query_directed on the same rows
    rd, rh = ref_query_directed(
        *[_ref_table(t) for t in tabs], jnp.asarray(u.numpy()),
        jnp.asarray(v.numpy()), with_hub=True)
    assert np.array_equal(d.numpy(), np.asarray(rd))
    assert np.array_equal(h.numpy(), np.asarray(rh))


def _ref_table(t):
    from repro.core.labels import LabelTable as RefTable
    return RefTable(*(jnp.asarray(x.numpy()) for x in t))


def test_label_query_pair_rows_refuses_cpu_and_unequal_tables():
    a = lbl.empty(4, 3, "cpu")
    b = lbl.empty(4, 5, "cpu")
    ids = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="differ in shape"):
        label_query_pair_rows(a, b, ids, ids)
    with pytest.raises(ValueError, match="CUDA"):
        label_query_pair_rows(a, a, ids, ids)
    with pytest.raises(ValueError, match="differ in shape"):
        query_table_pair(a, b, ids, ids)          # the CPU path refuses too
