"""Spill stores, version-1/2 artifacts and the ``serve_chl`` entry point
in the port, against the reference.

Mirrors the spill and format-migration cases of the reference's
``test_store.py``, ``test_serve.py`` (routed spill) and ``test_ft.py``
(quarantine), on the same seeded inputs: a memory-mapped store answers
(dist and hub) equal to the reference's spill store, routed and
unrouted; truncated members raise the typed error; verification keeps
the maps lazy; an injected ``spill.query`` fault quarantines the shard
and ``health()`` names it; version-1 artifacts (``arrays.npz``) load
dense and spilled and migrate on save, version-2 manifests round-trip;
``repro_torch.launch.serve_chl.main`` serves the same distances as the
reference's launcher; the load generators equal the reference's.
Every comparison is exact.
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import CHLIndex as RefIndex
from repro.index import build as ref_build
from repro.index.artifact import rank_hash
from repro.launch import serve_chl as ref_serve_chl
from repro.serve import zipf_pairs as ref_zipf_pairs
from repro_torch import interop
from repro_torch.dynamic import MutationBatch
from repro_torch.ft import Fault, FaultPlan, faults
from repro_torch.index import (BuildPlan, CHLIndex, CorruptArtifactError,
                               DenseStore, SpillStore, build)
from repro_torch.index.artifact import VERSION
from repro_torch.index.store import shard_filename
from repro_torch.launch import serve_chl
from repro_torch.serve import (QueryService, RoutedAnswer,
                               ShardUnavailableError, make_answer_fn,
                               poisson_open_loop, zipf_pairs)

torch.set_num_threads(1)


def small_graph():
    g = rg.scale_free(48, attach=2, seed=3)
    return g, degree_ranking(g)


def query_batch(n, count=96, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, count).astype(np.int64),
            rng.integers(0, n, count).astype(np.int64))


def port_build(g, rank, **kw):
    return build(interop.graph(g), rank, BuildPlan(**kw), device="cpu")


@pytest.fixture(scope="module")
def graph():
    return small_graph()


@pytest.fixture(scope="module")
def sharded(graph):
    """(port, reference) PLaNT builds into 2 hub shards."""
    g, rank = graph
    kw = dict(algo="plant", batch=8, store="sharded", shards=2)
    return port_build(g, rank, **kw), ref_build(g, rank, RefPlan(**kw))


@pytest.fixture
def saved(sharded, tmp_path):
    """The port's sharded build saved (the reference's layout)."""
    return sharded[0].save(str(tmp_path / "idx"))


def answers(idx, u, v):
    return idx.query_with_hub(u, v)


def ref_answers(idx, u, v):
    return idx.query_with_hub(u.astype(np.int32), v.astype(np.int32))


# ------------------------------------------------------------- spill

def test_spill_store_serves_memmapped_equal_to_reference(graph, sharded,
                                                         saved):
    g, rank = graph
    port, ref = sharded
    loaded = CHLIndex.load(saved, store="spill", device="cpu")
    rloaded = RefIndex.load(saved, store="spill")
    assert isinstance(loaded.store, SpillStore)
    assert loaded.store.is_mapped()
    assert loaded.store.resident_bytes() < loaded.store.label_bytes()
    assert loaded.store.label_bytes() == rloaded.store.label_bytes()
    u, v = query_batch(g.n)
    d, h = answers(loaded, u, v)
    rd, rh = ref_answers(rloaded, u, v)
    assert np.array_equal(d, rd) and np.array_equal(h, rh)
    assert np.array_equal(d, port.query(u, v))
    for k in range(2):
        pd, ph = loaded.store.query_shard(k, u, v)
        qd, qh = rloaded.store.query_shard(k, u, v)
        assert np.array_equal(pd, qd) and np.array_equal(ph, qh)
    for (_, a), (_, b) in zip(loaded.store.shard_arrays(),
                              rloaded.store.shard_arrays()):
        for key in ("hubs", "dist", "count"):
            assert np.array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_spill_intersection_in_chunks_equals_one_pass(graph, saved,
                                                      monkeypatch):
    """The plain intersection on the CPU runs in Q-chunks bounded by the
    budget; forcing many chunks changes no answer."""
    from repro_torch.kernels.label_query import ops
    g, _ = graph
    loaded = CHLIndex.load(saved, store="spill", device="cpu")
    u, v = query_batch(g.n, count=333)
    want = loaded.query_with_hub(u, v)
    monkeypatch.setattr(ops, "ROWS_BUDGET", 40)
    got = loaded.query_with_hub(u, v)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("routed", [None, True, False])
def test_spill_serve_routed_and_unrouted(graph, sharded, saved, routed):
    g, _ = graph
    port, _ = sharded
    spill = CHLIndex.load(saved, store="spill", device="cpu")
    u, v = query_batch(g.n, 128)
    svc = spill.serve(mode="qlsn", batch_size=32, routed=routed)
    svc.submit(u, v)
    assert np.array_equal(svc.flush(), port.query(u, v))
    fn = make_answer_fn(spill.store, "qlsn", routed=routed)
    assert isinstance(fn, RoutedAnswer) == (routed is not False)


def test_spill_refuses_distributed_modes(saved):
    spill = CHLIndex.load(saved, store="spill", device="cpu")
    for mode in ("qfdl", "qdol"):
        with pytest.raises(NotImplementedError,
                           match="needs labels in device memory"):
            spill.serve(mode=mode)


def test_spill_truncated_member_typed_error(saved):
    shard = os.path.join(saved, shard_filename(1))
    data = open(shard, "rb").read()
    with open(shard, "wb") as f:
        f.write(data[:len(data) // 2])
    with pytest.raises(CorruptArtifactError, match="truncated or"):
        CHLIndex.load(saved, store="spill", verify=False, device="cpu")
    with pytest.raises(CorruptArtifactError, match="sha256 mismatch"):
        CHLIndex.load(saved, store="spill", device="cpu")


def test_spill_verify_keeps_lazy_mapping(graph, sharded, saved):
    g, _ = graph
    spill = CHLIndex.load(saved, store="spill", device="cpu")
    assert spill.store.is_mapped()
    u, v = query_batch(g.n)
    assert np.array_equal(spill.query(u, v), sharded[0].query(u, v))
    # save migrates the mapped shards through the same layout
    again = CHLIndex.load(spill.save(saved + "_again"), device="cpu")
    assert np.array_equal(again.query(u, v), sharded[0].query(u, v))


def test_spill_query_fault_quarantines_the_shard(graph, saved):
    """An injected read failure at ``spill.query`` quarantines the shard
    a routed answer needed; the service's health names it."""
    g, _ = graph
    spill = CHLIndex.load(saved, store="spill", device="cpu")
    ra = RoutedAnswer(spill.store)
    need0 = np.nonzero(ra._has[0])[0]
    u = int(need0[0])
    with faults(FaultPlan({"spill.query": [Fault("io", count=1)]})):
        with pytest.raises(ShardUnavailableError, match="shard 0"):
            ra(u, u)
    assert "TransientIOError" in ra.quarantined[0]
    with pytest.raises(ShardUnavailableError):
        ra(u, u)                   # sticky, even after the site heals
    svc = QueryService(ra, batch_size=4, drop_first=False)
    svc.submit([u], [u])
    svc.drain()
    health = svc.health()
    assert health["status"] == "degraded"
    assert health["quarantined_shards"] == ra.quarantined


def test_spill_mapped_read_failure_is_typed(saved):
    """A mapped page that fails at read time raises
    CorruptArtifactError naming the shard."""
    spill = CHLIndex.load(saved, store="spill", device="cpu")

    class Gone:
        shape = spill.store._shards[1]["hubs"].shape

        def __getitem__(self, idx):
            raise OSError("bus error on mapped page")

    spill.store._shards[1]["hubs"] = Gone()
    with pytest.raises(CorruptArtifactError, match="spill shard 1"):
        spill.store.query_shard(1, [0], [1])


def test_interop_rebuilds_a_reference_spill_store(graph, sharded, saved):
    g, _ = graph
    rspill = RefIndex.load(saved, store="spill")
    store = interop.spill_store(rspill.store, device="cpu")
    assert store.is_mapped()
    u, v = query_batch(g.n)
    for a, b in zip(store.query(u, v), ref_answers(rspill, u, v)):
        assert np.array_equal(a, b)


def test_apply_refused_on_read_only_residencies(graph, saved):
    g, _ = graph
    spill = CHLIndex.load(saved, store="spill", device="cpu")
    with pytest.raises(NotImplementedError, match="spill"):
        spill.apply(MutationBatch([]), graph=interop.graph(g))


# ----------------------------------------------------- old formats

def write_v1_artifact(directory, idx, rank):
    """A pre-store artifact in the byte layout of format version 1."""
    os.makedirs(directory)
    t = idx.table
    np.savez(os.path.join(directory, "arrays.npz"), rank=rank,
             hubs=np.asarray(t.hubs), dist=np.asarray(t.dist),
             count=np.asarray(t.count))
    manifest = {"format": "repro.index/chl", "version": 1,
                "plan": idx.plan.to_dict(),
                "report": idx.report.to_dict(),
                "rank_hash": rank_hash(rank), "directed": False,
                "n": idx.n, "total_labels": idx.total_labels,
                "als": idx.als}
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("algo", ["plant", "gll"])
def test_v1_artifact_loads_dense_equal_to_reference(graph, tmp_path, algo):
    g, rank = graph
    ref = ref_build(g, rank, RefPlan(algo=algo, batch=4))
    d = str(tmp_path / "v1")
    write_v1_artifact(d, ref, rank)
    loaded = CHLIndex.load(d, rank=rank, device="cpu")
    rloaded = RefIndex.load(d, rank=rank)
    assert isinstance(loaded.store, DenseStore)
    for a, b in zip(loaded.table, rloaded.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    u, v = query_batch(g.n)
    for a, b in zip(answers(loaded, u, v), ref_answers(rloaded, u, v)):
        assert np.array_equal(a, b)
    # the loaded table is the port's own memory, writable in place
    loaded.table.dist[0, 0] = loaded.table.dist[0, 0]


def test_v1_artifact_spills_and_migrates_on_save(graph, tmp_path):
    g, rank = graph
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=8))
    d = str(tmp_path / "v1")
    write_v1_artifact(d, ref, rank)
    u, v = query_batch(g.n)
    spilled = CHLIndex.load(d, store="spill", device="cpu")
    assert spilled.store.is_mapped() and spilled.store.num_shards == 1
    for a, b in zip(answers(spilled, u, v),
                    ref_answers(RefIndex.load(d, store="spill"), u, v)):
        assert np.array_equal(a, b)
    p2 = CHLIndex.load(d, device="cpu").save(str(tmp_path / "v3"))
    with open(os.path.join(p2, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["version"] == VERSION == 3
    assert manifest["store"]["shards"] == 1
    assert os.path.exists(os.path.join(p2, shard_filename(0)))
    assert np.array_equal(RefIndex.load(p2).query(u.astype(np.int32),
                                                  v.astype(np.int32)),
                          ref.query(u.astype(np.int32), v.astype(np.int32)))


def test_v1_directed_artifact_loads(tmp_path):
    gd = rg.random_connected(16, extra_edges=12, seed=0, directed=True)
    rank = degree_ranking(gd)
    ref = ref_build(gd, rank, RefPlan(algo="directed", batch=4))
    d = str(tmp_path / "v1d")
    os.makedirs(d)
    arrays = {"rank": rank}
    for pfx, t in (("out_", ref.l_out), ("in_", ref.l_in)):
        for key, x in zip(("hubs", "dist", "count"), t):
            arrays[pfx + key] = np.asarray(x)
    np.savez(os.path.join(d, "arrays.npz"), **arrays)
    manifest = {"format": "repro.index/chl", "version": 1,
                "plan": ref.plan.to_dict(), "report": ref.report.to_dict(),
                "rank_hash": rank_hash(rank), "directed": True,
                "n": ref.n, "total_labels": ref.total_labels,
                "als": ref.als}
    with open(os.path.join(d, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    loaded = CHLIndex.load(d, device="cpu")
    assert loaded.directed
    u, v = query_batch(gd.n, 64)
    assert np.array_equal(loaded.query(u, v),
                          ref.query(u.astype(np.int32), v.astype(np.int32)))


@pytest.mark.parametrize("store_kind", ["sharded", "spill", "dense"])
def test_v2_round_trip(graph, sharded, saved, tmp_path, store_kind):
    """A version-2 manifest (no codec fields) loads in both packages with
    equal answers, and round-trips through a save."""
    g, rank = graph
    port, _ = sharded
    mpath = os.path.join(saved, "manifest.json")
    with open(mpath) as f:
        manifest = json.load(f)
    manifest["version"] = 2
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    loaded = CHLIndex.load(saved, rank=rank, store=store_kind, device="cpu")
    rloaded = RefIndex.load(saved, rank=rank, store=store_kind)
    assert loaded.store.kind == store_kind == rloaded.store.kind
    assert loaded.total_labels == port.total_labels
    u, v = query_batch(g.n)
    for a, b in zip(answers(loaded, u, v), ref_answers(rloaded, u, v)):
        assert np.array_equal(a, b)
    again = CHLIndex.load(loaded.save(str(tmp_path / "again")), rank=rank,
                          device="cpu")
    assert np.array_equal(again.query(u, v), port.query(u, v))


# ----------------------------------------------------- entry point

@pytest.mark.parametrize("argv", [
    [], ["--store", "spill"],
    ["--store", "compressed", "--codec", "u32", "--quant-exact"],
    ["--store", "compressed", "--codec", "bf16", "--no-routing"],
    ["--store", "sharded", "--shards", "3", "--zipf", "1.3"]],
    ids=["saved", "spill", "u32-exact", "bf16-unrouted", "sharded-zipf"])
def test_serve_chl_main_equals_reference(saved, argv, capsys):
    common = ["--index", saved, "--queries", "300", "--batch-size", "64",
              "--seed", "3"] + argv
    out = serve_chl.main(common + ["--device", "cpu"])
    ref = ref_serve_chl.main(common)
    assert np.array_equal(out["distances"], np.asarray(ref["distances"]))
    assert out["index"].store.kind == ref["index"].store.kind
    assert out["stats"]["queries"] == ref["stats"]["queries"] == 300
    assert "memory:" in capsys.readouterr().out


def test_serve_chl_open_loop(saved):
    out = serve_chl.main(["--index", saved, "--queries", "120",
                          "--batch-size", "16", "--arrival-qps", "20000",
                          "--cache", "64", "--zipf", "1.3",
                          "--device", "cpu"])
    assert out["stats"]["offered_queries"] == 120
    assert len(out["distances"]) + out["stats"]["rejected"] == 120


def test_load_generators_equal_reference(sharded, graph):
    g, _ = graph
    u, v = zipf_pairs(g.n, 500, np.random.default_rng(2))
    ru, rv = ref_zipf_pairs(g.n, 500, np.random.default_rng(2))
    assert np.array_equal(u, ru) and np.array_equal(v, rv)
    assert u.dtype == ru.dtype
    svc = sharded[0].serve(batch_size=32, cache=512, deadline_ms=1.0,
                           max_queue=1024)
    res = poisson_open_loop(svc, u[:150], v[:150], arrival_qps=5000.0)
    assert res["offered_queries"] == 150
    assert res["queries"] + res["rejected"] == 150
    with pytest.raises(ValueError):
        poisson_open_loop(svc, u, v, arrival_qps=0.0)
