"""Hub-sharded label stores in the port, against the reference.

Mirrors the sharded cases of the reference's ``test_store.py``,
``test_engine.py`` (streaming sharding), ``test_serve.py`` (routing),
``test_dynamic.py`` (sharded repair) and ``test_ft.py`` (quarantine),
and holds the port's arrays against the reference's on the same numpy
inputs: hub ownership and the partition, the streaming accumulator and
its checkpoint payload, every shard of a ``store="sharded"`` build
(streamed for PLaNT/pll-ref, re-homed for the GLL family), stacked and
routed answers (hubs included, a tie across shards too), artifacts and
checkpoints that cross the packages both ways, re-homing on load and
the sharded repair. Weights are integral f32: every comparison is
exact.
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
from repro.core.pll import pll_undirected
from repro.dynamic import MutationBatch as RefBatch
from repro.engine import run_build as ref_run_build
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import CHLIndex as RefIndex
from repro.index import build as ref_build
from repro.index.store import ShardedStore as RefSharded
from repro.parallel import sharding as ref_sharding
from repro.serve.routing import RoutedAnswer as RefRouted
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import labels as lbl
from repro_torch.core import validate
from repro_torch.dynamic import MutationBatch, random_mutations
from repro_torch.engine import run_build
from repro_torch.index import (BuildPlan, CHLIndex, CorruptArtifactError,
                               DenseStore, build)
from repro_torch.index.store import ShardedStore, shard_filename
from repro_torch.parallel import (ShardAccumulator, hub_owner,
                                  hub_partition_arrays)
from repro_torch.serve import (QueryService, RoutedAnswer,
                               ShardUnavailableError, make_answer_fn,
                               make_routed_answer_fn)

torch.set_num_threads(1)

KEYS = ("hubs", "dist", "count")


def small_graph():
    g = rg.scale_free(48, attach=2, seed=3)
    return g, degree_ranking(g)


def query_batch(n, count=96, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, count).astype(np.int64),
            rng.integers(0, n, count).astype(np.int64))


def port_build(g, rank, **kw):
    return build(interop.graph(g), rank, BuildPlan(**kw), device="cpu")


def shards_equal(a, b) -> bool:
    """Shard by shard, raw bit-identity (slot order and padding), for
    any two stores or accumulators of either package."""
    sa, sb = list(a.shard_arrays()), list(b.shard_arrays())
    if [k for k, _ in sa] != [k for k, _ in sb]:
        return False
    return all(np.array_equal(np.asarray(x[key]), np.asarray(y[key]))
               for (_, x), (_, y) in zip(sa, sb) for key in KEYS)


def drop_steps_after(tmp, mgr, keep: int) -> int:
    steps = mgr.all_steps()
    assert len(steps) > keep, "scenario needs a later checkpoint to drop"
    for s in steps[keep:]:
        shutil.rmtree(os.path.join(str(tmp), f"step_{s:010d}"))
    return steps[keep - 1]


@pytest.fixture(scope="module")
def built():
    """(graph, port dense, port 3-shard, reference 3-shard) of one
    PLaNT build."""
    g, rank = small_graph()
    dense = port_build(g, rank, algo="plant", batch=8)
    sharded = port_build(g, rank, algo="plant", batch=8, store="sharded",
                         shards=3)
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=8,
                                     store="sharded", shards=3))
    return g, dense, sharded, ref


# ------------------------------------------------------- the partition

@pytest.mark.parametrize("K", [1, 2, 3, 5])
def test_hub_partition_equals_reference(K):
    g, rank = small_graph()
    table = ref_build(g, rank, RefPlan(algo="plant", batch=8)).table
    assert np.array_equal(hub_owner(rank, K),
                          ref_sharding.hub_owner(rank, K))
    got = hub_partition_arrays(np.asarray(table.hubs),
                               np.asarray(table.dist), rank, K)
    want = ref_sharding.hub_partition_arrays(table.hubs, table.dist, rank, K)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="shard_cap"):
        hub_partition_arrays(np.asarray(table.hubs), np.asarray(table.dist),
                             rank, K, shard_cap=1)


def test_accumulator_regrows_and_checkpoints_like_reference():
    rng = np.random.default_rng(7)
    n, K = 30, 3
    rank = rng.permutation(n)
    port = ShardAccumulator(n, rank, K, init_cap=2)
    ref = ref_sharding.ShardAccumulator(n, rank, K, init_cap=2)
    for step in range(6):               # rows pass the cap: shards regrow
        roots = rng.choice(n, 4, replace=False)
        valid = np.array([True, True, step % 2 == 0, True])
        emit = rng.random((4, n)) < 0.6
        dist = rng.integers(0, 50, (4, n)).astype(np.float32)
        assert port.insert(roots, valid, emit, dist) == \
            ref.insert(roots, valid, emit, dist)
    assert port.total_labels == ref.total_labels
    assert [a.shape for a in port.hubs] == [a.shape for a in ref.hubs]
    assert shards_equal(port, ref)
    ps, rs = port.state_arrays(), ref.state_arrays()
    assert sorted(ps) == sorted(rs)
    for k in ps:
        assert ps[k].dtype == rs[k].dtype and np.array_equal(ps[k], rs[k])
    back = ShardAccumulator(n, rank, K)
    back.load_state(rs)
    assert shards_equal(back, ref)


# ------------------------------------------------------------- parity

def test_sharded_store_query_parity_with_dense(built):
    g, dense, sharded, _ = built
    assert isinstance(dense.store, DenseStore)
    assert isinstance(sharded.store, ShardedStore)
    assert sharded.store.num_shards == 3
    assert sharded.total_labels == dense.total_labels
    u, v = query_batch(g.n)
    np.testing.assert_array_equal(sharded.query(u, v), dense.query(u, v))
    d, h = sharded.query_with_hub(u, v)
    finite = np.isfinite(d)
    assert (h[finite] >= 0).all() and (h[~finite] == -1).all()


def test_sharded_store_partition_is_exact_by_hub(built):
    g, dense, _, _ = built
    st = ShardedStore.from_table(dense.table, dense.rank, 3)
    assert lbl.to_numpy_sets(st.to_table()) == \
        lbl.to_numpy_sets(dense.table)


def test_sharded_answers_and_hubs_equal_reference(built):
    """Stacked answers and witness hubs equal the reference's, and the
    merged table and re-homing equal its arrays."""
    g, dense, sharded, ref = built
    assert shards_equal(sharded.store, ref.store)
    u, v = query_batch(g.n, 400)
    d, h = sharded.store.query(u, v)
    rd, rh = ref.store.query(u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(d, rd) and np.array_equal(h, rh)
    for a, b in zip(sharded.table, ref.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert sharded.memory_report() == ref.memory_report()
    assert sharded.store.shard_label_bytes() == \
        ref.store.shard_label_bytes()


def test_stacked_hubs_part_from_dense_only_on_ties():
    """The stacked witness is a real one, and differs from the dense
    store's (the first attaining slot of the row) only where several
    hubs attain the minimum: the reference's own rule, kept."""
    g = rg.grid_road(12, 12, seed=7)               # many tied paths
    rank = degree_ranking(g)
    dense = port_build(g, rank, algo="plant", batch=8)
    sharded = port_build(g, rank, algo="plant", batch=8, store="sharded",
                         shards=4)
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=8, store="sharded",
                                     shards=4))
    u, v = query_batch(g.n, 2000, seed=3)
    d, h = sharded.query_with_hub(u, v)
    rd, rh = ref.query_with_hub(u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(d, rd) and np.array_equal(h, rh)
    dd, dh = dense.query_with_hub(u, v)
    assert np.array_equal(d, dd)
    sets = lbl.to_numpy_sets(dense.table)
    for q in range(len(u)):
        lu, lv = sets[u[q]], sets[v[q]]
        assert lu[h[q]] + lv[h[q]] == d[q]          # a real witness
        attaining = [x for x in lu if x in lv and lu[x] + lv[x] == d[q]]
        assert h[q] == dh[q] or len(attaining) > 1
    assert (h != dh).any()                          # the case is covered


def test_stacked_tie_across_shards_takes_the_lowest_shard():
    """Two shards attain the same minimum with different hubs: the
    winner is the lowest shard's hub, as the reference's argmin picks."""
    h = np.full((3, 4, 2), -1, np.int32)
    d = np.full((3, 4, 2), np.inf, np.float32)
    c = np.zeros((3, 4), np.int32)

    def put(k, row, slots):
        for i, (hub, dist) in enumerate(slots):
            h[k, row, i], d[k, row, i] = hub, dist
        c[k, row] = len(slots)

    put(1, 0, [(5, 2.0)])          # shard 1: 5 + 1 = 3 for (0, 1)
    put(1, 1, [(5, 1.0)])
    put(2, 0, [(6, 1.0), (7, 9.0)])  # shard 2: 6 gives 1 + 2 = 3 too
    put(2, 1, [(6, 2.0)])
    put(0, 2, [(8, 0.0)])
    put(0, 3, [(8, 4.0)])
    store = ShardedStore(torch.as_tensor(h), torch.as_tensor(d),
                         torch.as_tensor(c))
    u = np.array([0, 1, 2, 0, 3])
    v = np.array([1, 0, 3, 3, 3])
    got = store.query(u, v)
    want = RefSharded(jnp.asarray(h), jnp.asarray(d), jnp.asarray(c)).query(
        u.astype(np.int32), v.astype(np.int32))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1],
                                                             want[1])
    assert got[1][0] == got[1][1] == 5 and got[0][0] == 3.0
    assert got[1][3] == -1                   # disjoint in every shard
    routed = RoutedAnswer(store)(u, v)
    assert torch.equal(routed, torch.as_tensor(got[0]))


def test_sharded_store_refuses_broken_padding():
    h = np.full((2, 3, 2), -1, np.int32)
    d = np.full((2, 3, 2), np.inf, np.float32)
    c = np.zeros((2, 3), np.int32)
    d[1, 2, 1] = 4.0                         # past the count
    with pytest.raises(ValueError, match="padding"):
        ShardedStore(torch.as_tensor(h), torch.as_tensor(d),
                     torch.as_tensor(c))
    with pytest.raises(ValueError, match=r"\[K, n, Ls\]"):
        ShardedStore(torch.as_tensor(h[0]), torch.as_tensor(d[0]),
                     torch.as_tensor(c[0]))


# --------------------------------------------------------- the builds

@pytest.mark.parametrize("algo", ["plant", "pll-ref", "gll", "lcc",
                                  "parapll"])
def test_sharded_build_shards_equal_reference(algo):
    """PLaNT and pll-ref stream into the shards; the GLL family builds
    dense and re-homes. Every shard equals the reference's."""
    g, rank = small_graph()
    port = port_build(g, rank, algo=algo, batch=8, store="sharded",
                      shards=3)
    ref = ref_build(g, rank, RefPlan(algo=algo, batch=8, store="sharded",
                                     shards=3))
    assert shards_equal(port.store, ref.store)
    p, r = port.report.to_dict(), ref.report.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    p.pop("notes"), r.pop("notes")
    assert p == r
    u, v = query_batch(g.n, 128)
    assert np.array_equal(port.query(u, v), np.asarray(ref.query(u, v)))


def test_streaming_sharded_equals_dense_then_rehome():
    g, rank = small_graph()
    pg = interop.graph(g)
    dense = run_build(pg, rank, algo="plant", batch=8,
                      device="cpu").sink.table()
    rehomed = ShardedStore.from_table(dense, rank, 3)
    res = run_build(pg, rank, algo="plant", batch=8, streaming_shards=3,
                    device="cpu")
    streamed = ShardedStore.from_accumulator(res.sink.acc, device="cpu")
    assert streamed.num_shards == rehomed.num_shards == 3
    assert shards_equal(streamed, rehomed)
    ref = ref_run_build(g, rank, algo="plant", batch=8, streaming_shards=3)
    assert shards_equal(res.sink, ref.sink)
    assert res.sink.meta() == ref.sink.meta()


def test_streaming_build_never_materializes_dense_table(monkeypatch):
    g, rank = small_graph()

    def boom(*a, **k):                         # pragma: no cover
        raise AssertionError("dense-table path used in streaming build")

    monkeypatch.setattr(lbl, "insert_batch", boom)
    monkeypatch.setattr(lbl, "empty", boom)
    idx = port_build(g, rank, algo="plant", batch=8, store="sharded",
                     shards=2)
    assert idx.store.kind == "sharded" and idx.store.num_shards == 2
    monkeypatch.undo()
    assert idx.validate_against(interop.graph(g))


def test_streaming_build_facade_matches_rehomed_queries():
    g, rank = small_graph()
    streamed = port_build(g, rank, algo="plant", batch=8, store="sharded",
                          shards=3)
    rehomed = port_build(g, rank, algo="gll", batch=8, store="sharded",
                         shards=3)
    u, v = query_batch(g.n, 128, seed=0)
    np.testing.assert_array_equal(streamed.query(u, v), rehomed.query(u, v))


def test_streaming_rejects_table_dependent_algos():
    g, rank = small_graph()
    with pytest.raises(ValueError, match="streaming") as port_err:
        run_build(interop.graph(g), rank, algo="gll", batch=4,
                  streaming_shards=2, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        ref_run_build(g, rank, algo="gll", batch=4, streaming_shards=2)
    assert str(port_err.value) == str(ref_err.value)


def test_pll_ref_streams_too():
    g, rank = small_graph()
    res = run_build(interop.graph(g), rank, algo="pll-ref", batch=8,
                    streaming_shards=2, device="cpu")
    store = ShardedStore.from_accumulator(res.sink.acc, device="cpu")
    validate.check_equal(lbl.to_numpy_sets(store.to_table()),
                         pll_undirected(g, rank))


def test_default_shard_count_is_the_device_count():
    g, rank = small_graph()
    idx = port_build(g, rank, algo="plant", batch=8, store="sharded")
    assert idx.store.num_shards == 1          # one CPU


# --------------------------------------------------------- checkpoints

def test_streaming_sharded_resume(tmp_path):
    g, rank = small_graph()
    pg = interop.graph(g)
    mgr = CheckpointManager(str(tmp_path), keep=100)
    full = run_build(pg, rank, algo="plant", batch=8, streaming_shards=2,
                     ckpt=mgr, device="cpu")
    cursor = drop_steps_after(tmp_path, mgr, keep=2)
    res = run_build(pg, rank, algo="plant", batch=8, streaming_shards=2,
                    ckpt=CheckpointManager(str(tmp_path), keep=100),
                    resume=True, device="cpu")
    assert res.resumed_from == cursor
    assert shards_equal(res.sink, full.sink)


def test_streaming_step_files_equal_reference(tmp_path):
    g, rank = small_graph()
    run_build(interop.graph(g), rank, algo="plant", batch=8,
              streaming_shards=3, device="cpu",
              ckpt=CheckpointManager(str(tmp_path / "port"), keep=100))
    ref_run_build(g, rank, algo="plant", batch=8, streaming_shards=3,
                  ckpt=RefManager(str(tmp_path / "ref"), keep=100))
    names = [x for x in sorted(os.listdir(tmp_path / "port"))
             if x.startswith("step_")]
    assert names and names == [x for x in sorted(os.listdir(tmp_path /
                                                            "ref"))
                               if x.startswith("step_")]
    for name in names:
        files = []
        for side in ("port", "ref"):
            d = tmp_path / side / name
            with open(d / "manifest.json") as f:
                manifest = json.load(f)
            with np.load(d / "arrays.npz") as z:
                files.append((manifest, {k: z[k] for k in z.files}))
        (pm, pa), (rm, ra) = files
        assert pm == rm, name
        assert pm["data_state"]["sink"] == {"kind": "sharded", "cap": None,
                                            "n": g.n, "shards": 3}
        assert list(pa) == list(ra)
        for k in pa:
            assert pa[k].shape == ra[k].shape, k
            assert pa[k].dtype == ra[k].dtype, k
            assert np.array_equal(pa[k], ra[k], equal_nan=True), k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_streaming_checkpoints_resume_across_packages(tmp_path, writer):
    g, rank = small_graph()
    pg = interop.graph(g)
    src = tmp_path / "src"
    if writer == "reference":
        mgr = RefManager(str(src), keep=100)
        ref_run_build(g, rank, algo="plant", batch=8, streaming_shards=2,
                      ckpt=mgr)
    else:
        mgr = CheckpointManager(str(src), keep=100)
        run_build(pg, rank, algo="plant", batch=8, streaming_shards=2,
                  ckpt=mgr, device="cpu")
    cursor = drop_steps_after(src, mgr, keep=2)
    shutil.copytree(src, tmp_path / "copy")
    port = run_build(pg, rank, algo="plant", batch=8, streaming_shards=2,
                     ckpt=CheckpointManager(str(src), keep=100),
                     resume=True, device="cpu")
    ref = ref_run_build(g, rank, algo="plant", batch=8, streaming_shards=2,
                        ckpt=RefManager(str(tmp_path / "copy"), keep=100),
                        resume=True)
    assert port.resumed_from == ref.resumed_from == cursor
    assert shards_equal(port.sink, ref.sink)
    assert [r.to_dict() for r in port.records] == \
        [r.to_dict() for r in ref.records]


# ---------------------------------------------------------- artifacts

def test_sharded_round_trip(tmp_path, built):
    g, dense, sharded, _ = built
    path = sharded.save(str(tmp_path / "idx"))
    with open(os.path.join(path, "manifest.json")) as f:
        info = json.load(f)["store"]
    assert info["kind"] == "sharded" and info["shards"] == 3
    assert info["shard_labels"] == [int(c.sum()) for c in
                                    sharded.store.count]
    loaded = CHLIndex.load(path, rank=sharded.rank, device="cpu")
    assert loaded.store.kind == "sharded" and loaded.store.num_shards == 3
    assert shards_equal(loaded.store, sharded.store)
    u, v = query_batch(g.n)
    np.testing.assert_array_equal(loaded.query(u, v), dense.query(u, v))
    again = CHLIndex.load(loaded.save(str(tmp_path / "idx2")),
                          device="cpu")
    assert shards_equal(again.store, sharded.store)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_sharded_artifacts_cross_packages(tmp_path, built, writer):
    g, _, sharded, ref = built
    if writer == "reference":
        loaded = CHLIndex.load(ref.save(str(tmp_path / "idx")),
                               rank=ref.rank, device="cpu")
        want = ref
    else:
        loaded = RefIndex.load(sharded.save(str(tmp_path / "idx")),
                               rank=sharded.rank)
        want = sharded
    assert loaded.store.kind == "sharded"
    assert shards_equal(loaded.store, want.store)


def test_load_rehomes_between_kinds_like_reference(tmp_path, built):
    """dense -> sharded (K = 3), sharded -> dense, sharded K = 3 -> 2:
    each re-homed store equals the reference's re-homing of the same
    artifact, array for array."""
    g, dense, sharded, _ = built
    d_path = dense.save(str(tmp_path / "dense"))
    s_path = sharded.save(str(tmp_path / "sharded"))
    for path, kw in ((d_path, dict(store="sharded", shards=3)),
                     (d_path, dict(store="sharded")),
                     (s_path, dict(store="dense")),
                     (s_path, dict(store="sharded", shards=2)),
                     (s_path, dict(store="sharded"))):
        got = CHLIndex.load(path, device="cpu", **kw)
        want = RefIndex.load(path, **kw)
        assert got.store.kind == want.store.kind, kw
        assert got.store.num_shards == want.store.num_shards, kw
        assert shards_equal(got.store, want.store), (path, kw)
    u, v = query_batch(g.n)
    ref = dense.query(u, v)
    np.testing.assert_array_equal(
        CHLIndex.load(d_path, store="sharded", shards=3,
                      device="cpu").query(u, v), ref)


def test_rank_hash_rejection_per_shard_layout(tmp_path, built):
    _, _, sharded, _ = built
    path = sharded.save(str(tmp_path / "idx"))
    wrong = sharded.rank.copy()
    wrong[:2] = wrong[1::-1]
    with pytest.raises(ValueError, match="rank-hash mismatch"):
        CHLIndex.load(path, rank=wrong, device="cpu")
    np.save(os.path.join(path, "rank.npy"), wrong)
    with pytest.raises(ValueError, match="corrupt"):
        CHLIndex.load(path, device="cpu")


def test_missing_shard_file_clear_error(tmp_path, built):
    _, _, sharded, _ = built
    path = sharded.save(str(tmp_path / "idx"))
    os.remove(os.path.join(path, shard_filename(1)))
    with pytest.raises(CorruptArtifactError, match="missing shard file"):
        CHLIndex.load(path, device="cpu")
    with pytest.raises(CorruptArtifactError, match="missing shard file"):
        CHLIndex.load(path, device="cpu", verify=False)


def test_truncated_shard_file_clear_error(tmp_path, built):
    _, _, sharded, _ = built
    path = sharded.save(str(tmp_path / "idx"))
    shard = os.path.join(path, shard_filename(0))
    with open(shard, "rb") as f:
        data = f.read()
    with open(shard, "wb") as f:
        f.write(data[:len(data) // 3])
    with pytest.raises(CorruptArtifactError, match="sha256 mismatch"):
        CHLIndex.load(path, device="cpu")
    with pytest.raises(CorruptArtifactError, match="truncated or corrupt"):
        CHLIndex.load(path, device="cpu", verify=False)


def test_tampered_shard_labels_clear_error(tmp_path, built):
    _, _, sharded, _ = built
    path = sharded.save(str(tmp_path / "idx"))
    shard = os.path.join(path, shard_filename(0))
    with np.load(shard) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["count"] = np.zeros_like(arrs["count"])
    np.savez(shard, **arrs)
    with pytest.raises(CorruptArtifactError):
        CHLIndex.load(path, device="cpu")
    with pytest.raises(ValueError, match="manifest recorded"):
        CHLIndex.load(path, device="cpu", verify=False)


def test_plan_store_validation():
    with pytest.raises(ValueError, match="spill"):
        BuildPlan(store="spill")
    with pytest.raises(ValueError):
        BuildPlan(store="bogus")
    with pytest.raises(ValueError):
        BuildPlan(store="sharded", shards=0)
    plan = BuildPlan(store="sharded", shards=4)
    assert BuildPlan.from_dict(plan.to_dict()) == plan
    with pytest.raises(ValueError, match="not one of"):
        CHLIndex.load("nowhere", store="bogus", device="cpu")


# ------------------------------------------------------------ routing

def test_routed_sharded_parity_and_shard_skipping(built):
    g, dense, sharded, ref = built
    u, v = query_batch(g.n, 128)
    stacked = sharded.store.query(u, v)[0]
    routed = make_routed_answer_fn(sharded.store)
    np.testing.assert_array_equal(routed(u, v).numpy(), stacked)
    np.testing.assert_array_equal(stacked, dense.query(u, v))
    np.testing.assert_array_equal(
        routed(u, v).numpy(), RefRouted(ref.store)(u, v))
    has = sharded.store.shard_counts() > 0
    assert not (has[:, u] & has[:, v]).all()   # some (query, shard) skipped
    assert np.array_equal(has, ref.store.shard_counts() > 0)
    for k in range(3):                         # the per-shard partials
        got, want = sharded.store.query_shard(k, u, v), \
            ref.store.query_shard(k, u.astype(np.int32), v.astype(np.int32))
        assert all(np.array_equal(a, np.asarray(b))
                   for a, b in zip(got, want))
    # a dense store is its own single shard
    assert np.array_equal(dense.store.shard_counts(),
                          dense.table.count.numpy()[None])
    for a, b in zip(dense.store.query_shard(0, u, v), dense.store.query(u, v)):
        assert np.array_equal(a, b)
    with pytest.raises(IndexError, match="one shard"):
        dense.store.query_shard(1, u, v)


def test_make_answer_fn_routed_flag(built):
    g, dense, sharded, _ = built
    u, v = query_batch(g.n, 64)
    ref = dense.query(u, v)
    auto = make_answer_fn(sharded.store, "qlsn")
    forced_off = make_answer_fn(sharded.store, "qlsn", routed=False)
    assert isinstance(auto, RoutedAnswer)
    assert not isinstance(forced_off, RoutedAnswer)
    np.testing.assert_array_equal(auto(torch.as_tensor(u),
                                       torch.as_tensor(v)).numpy(), ref)
    np.testing.assert_array_equal(forced_off(u, v).numpy(), ref)
    fn = make_answer_fn(dense.store, "qlsn", routed=True)  # never routes
    assert not isinstance(fn, RoutedAnswer)
    np.testing.assert_array_equal(fn(u, v).numpy(), ref)
    # qfdl never routes: the stacked reduction off a matching mesh
    np.testing.assert_array_equal(
        make_answer_fn(sharded.store, "qfdl", routed=True)(u, v).numpy(),
        ref)


def test_sharded_query_device_returns_tensors(built):
    g, dense, sharded, _ = built
    u, v = query_batch(g.n, 64)
    d, h = sharded.store.query_device(u, v)
    assert isinstance(d, torch.Tensor) and isinstance(h, torch.Tensor)
    np.testing.assert_array_equal(d.numpy(), dense.query(u, v))
    assert isinstance(make_answer_fn(sharded.store, "qlsn",
                                     routed=False)(u, v), torch.Tensor)


@pytest.mark.parametrize("routed", [None, False])
def test_sharded_serving_equals_dense(built, routed):
    g, dense, sharded, _ = built
    u, v = query_batch(g.n, 90, seed=8)
    svc = sharded.serve(mode="qlsn", batch_size=32, routed=routed, cache=16)
    svc.submit(u, v)
    np.testing.assert_array_equal(svc.flush(), dense.query(u, v))
    svc.submit(u[:20], v[:20])                 # cache hits
    np.testing.assert_array_equal(svc.flush(), dense.query(u[:20], v[:20]))


# ------------------------------------------------- degradation (test_ft)

def road_sharded():
    g = rg.grid_road(8, 8, seed=2)
    rank = degree_ranking(g)
    return g, rank, port_build(g, rank, algo="plant", batch=8,
                               store="sharded", shards=2)


def test_quarantined_shard_typed_error_and_health():
    g, rank, idx = road_sharded()
    ra = RoutedAnswer(idx.store)
    orig = idx.store.query_shard_device
    calls = {"n": 0}

    def failing(k, us, vs):
        if k == 0:
            calls["n"] += 1
            raise ValueError("mapped read failed")
        return orig(k, us, vs)

    idx.store.query_shard_device = failing
    try:
        u = int(np.nonzero(ra._has[0])[0][0])
        with pytest.raises(ShardUnavailableError, match="shard 0"):
            ra(u, u)
        assert 0 in ra.quarantined
        assert "mapped read failed" in ra.quarantined[0]
        with pytest.raises(ShardUnavailableError):
            ra(u, u)                       # quarantined: not retried
        assert calls["n"] == 1
    finally:
        idx.store.query_shard_device = orig
    with pytest.raises(ShardUnavailableError):
        ra(u, u)                           # sticky until reloaded
    other = np.nonzero(ra._has[1] & ~ra._has[0])[0]
    if len(other):
        w = int(other[0])
        assert np.isfinite(ra(w, w)[0].item())
    svc = QueryService(ra, batch_size=4, drop_first=False)
    svc.submit([u], [u])
    svc.drain()
    health = svc.health()
    assert health["status"] == "degraded"
    assert health["quarantined_shards"] == ra.quarantined
    assert svc.stats()["answer_failures"] == 1


def test_serve_wires_degradation_knobs():
    _, _, idx = road_sharded()
    svc = idx.serve(mode="qlsn", batch_size=32, timeout_ms=250,
                    breaker_threshold=3, breaker_reset_s=5.0)
    assert svc.timeout_s == pytest.approx(0.25)
    assert svc.breaker_threshold == 3
    assert svc.breaker_reset_s == 5.0
    assert svc.health()["status"] == "ok"
    assert svc.health()["quarantined_shards"] == {}


# ------------------------------------------------------- sharded repair

@pytest.mark.parametrize("seed", [5, 6])
def test_repair_mixed_batch_bit_identical_sharded(seed):
    """apply() on a 2-shard index equals a sharded rebuild on the mutated
    graph and the reference's repair of its own index: shards, report."""
    from repro.dynamic import store_fingerprint as ref_fingerprint
    from repro_torch.dynamic import store_fingerprint
    g, rank = rg.grid_road(8, 8, seed=2), None
    rank = degree_ranking(g)
    pg = interop.graph(g)
    batch = random_mutations(pg, np.random.default_rng(seed), inserts=1,
                             deletes=1, reweights=2)
    idx = port_build(g, rank, algo="plant", batch=8, store="sharded",
                     shards=2)
    rep = idx.apply(batch, graph=pg)
    assert rep.store == "sharded" and rep.cap is None
    assert idx.store.num_shards == 2
    g_new = batch.apply(pg)
    again = build(g_new, rank, BuildPlan(algo="plant", batch=8,
                                         store="sharded", shards=2),
                  device="cpu")
    assert shards_equal(idx.store, again.store)
    idx.validate_against(g_new)
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=8, store="sharded",
                                     shards=2))
    ref_rep = ref.apply(RefBatch.from_dict(batch.to_dict()), graph=g)
    assert shards_equal(idx.store, ref.store)
    assert store_fingerprint(idx.store) == ref_fingerprint(ref.store)
    p, r = rep.to_dict(), ref_rep.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r


def test_sharded_repair_equals_dense_repair_rehomed():
    sg = rg.scale_free(96, attach=2, seed=1)
    rank = degree_ranking(sg)
    pg = interop.graph(sg)
    batch = random_mutations(pg, np.random.default_rng(2), inserts=2,
                             deletes=1, reweights=1)
    dense = port_build(sg, rank, algo="plant", batch=8)
    sharded = port_build(sg, rank, algo="plant", batch=8, store="sharded",
                         shards=3)
    dense.apply(batch, graph=pg)
    sharded.apply(batch, graph=pg)
    assert shards_equal(sharded.store, ShardedStore.from_table(
        dense.table, rank, 3))


def test_apply_of_an_empty_batch_keeps_the_shards():
    g, rank, idx = road_sharded()
    before = list(idx.store.shard_arrays())
    rep = idx.apply(MutationBatch([]), graph=interop.graph(g))
    assert rep.affected == 0 and rep.repaired == 0
    after = list(idx.store.shard_arrays())
    assert all(np.array_equal(a[1][k], b[1][k])
               for a, b in zip(before, after) for k in KEYS)

