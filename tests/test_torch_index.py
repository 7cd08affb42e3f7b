"""The port's main path as a whole against the reference package.

``build(g, rank, BuildPlan(algo="plant"))`` -> ``query_with_hub`` ->
``save``/``load`` -> ``serve(mode="qlsn")``: identical label tables
(slot order and padding included), superstep records, overflow
regrowth and query answers; artifacts written by either package load
in the other with equal arrays and equal manifests (apart from the
wall time and the npz checksums, which carry zip timestamps).
"""

import json
import os

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.graphs.ranking import betweenness_ranking, random_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import CHLIndex as RefIndex
from repro.index import build as ref_build
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.dynamic import MutationBatch
from repro_torch.engine import run_build
from repro_torch.index import (BuildPlan, CHLIndex, CorruptArtifactError,
                               build)

torch.set_num_threads(1)


def _case(kind):
    if kind == "grid":
        g = rg.grid_road(7, 7, seed=3)
        return g, betweenness_ranking(g, samples=6)
    g = rg.random_connected(48, 40, seed=9, max_w=3)       # tie-heavy
    return g, random_ranking(g.n, seed=2)


@pytest.fixture(scope="module", params=[("grid", 8, None),
                                        ("ties", 6, None),
                                        ("ties", 16, 3)])
def built(request):
    """(port index, reference index, graph, rank) for one plan;
    ``cap=3`` forces the overflow regrow loop."""
    kind, batch, cap = request.param
    g, rank = _case(kind)
    port = build(interop.graph(g), rank,
                 BuildPlan(algo="plant", batch=batch, cap=cap),
                 device="cpu")
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=batch, cap=cap))
    return port, ref, g, rank


def test_label_tables_identical(built):
    port, ref, _, _ = built
    for a, b in zip(port.table, ref.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert port.total_labels == ref.total_labels and port.als == ref.als


def test_reports_identical(built):
    port, ref, _, _ = built
    p, r = port.report.to_dict(), ref.report.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r
    assert port.report.supersteps and all(
        s.sweeps > 0 for s in port.report.supersteps)


def test_cap_regrow_recorded():
    g, rank = _case("ties")
    port = build(interop.graph(g), rank,
                 BuildPlan(algo="plant", batch=16, cap=3), device="cpu")
    ev = [e.to_dict() for e in port.report.overflow_events]
    assert ev and ev[0]["cap"] == 3 and ev[0]["regrown_to"] == 6
    assert port.report.cap > 3


def test_query_with_hub_identical(built):
    port, ref, g, _ = built
    rng = np.random.default_rng(4)
    u = rng.integers(0, g.n, 300).astype(np.int32)
    v = rng.integers(0, g.n, 300).astype(np.int32)
    pd, ph = port.query_with_hub(u, v)
    rd, rh = ref.query_with_hub(u, v)
    assert pd.dtype == np.float32 and ph.dtype == np.int32
    assert np.array_equal(pd, rd) and np.array_equal(ph, rh)
    assert np.array_equal(port.query(u, v), rd)


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    m["report"].pop("wall_s")
    m["store"].pop("shard_sha256")
    return m


def test_artifacts_interoperate_both_ways(built, tmp_path):
    port, ref, _, rank = built
    p_dir = port.save(str(tmp_path / "port"))
    r_dir = ref.save(str(tmp_path / "ref"))
    assert _manifest(p_dir) == _manifest(r_dir)
    assert np.array_equal(np.load(os.path.join(p_dir, "rank.npy")),
                          np.load(os.path.join(r_dir, "rank.npy")))
    in_ref = RefIndex.load(p_dir, rank=rank)
    in_port = CHLIndex.load(r_dir, rank=rank, device="cpu")
    for a, b, c in zip(port.table, in_ref.table, in_port.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
        assert np.array_equal(a.numpy(), c.numpy())
    assert in_port.report.to_dict() == ref.report.to_dict()
    assert in_port.plan.to_dict() == ref.plan.to_dict()


def test_serve_flush_equals_query(built):
    port, _, g, _ = built
    rng = np.random.default_rng(6)
    u = rng.integers(0, g.n, 100)
    v = rng.integers(0, g.n, 100)
    want = port.query(u, v)
    srv = port.serve(mode="qlsn", batch_size=32, cache=64)
    srv.submit(u, v)                        # 3 full launches + a tail
    assert np.array_equal(srv.flush(), want)
    srv.submit(v, u)                        # symmetric cache hits
    assert np.array_equal(srv.flush(), want)
    st = srv.stats()
    assert st["queries"] == 200 and st["cache_hit_rate"] > 0


def test_load_rejects_corruption_and_foreign_rank(built, tmp_path):
    port, _, _, rank = built
    d = port.save(str(tmp_path / "idx"))
    with pytest.raises(ValueError, match="rank-hash"):
        CHLIndex.load(d, rank=rank[::-1].copy(), device="cpu")
    shard = os.path.join(d, "shard_0.npz")
    raw = bytearray(open(shard, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(shard, "wb").write(bytes(raw))
    with pytest.raises(CorruptArtifactError, match="sha256"):
        CHLIndex.load(d, device="cpu")


def test_unported_paths_raise():
    g, rank = _case("grid")
    pg = interop.graph(g)
    for plan in (BuildPlan(algo="dgll"), BuildPlan(algo="plant",
                                                    store="sharded")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build(pg, rank, plan, device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        run_build(pg, rank, algo="directed", device="cpu")
    idx = build(pg, rank, BuildPlan(algo="plant"), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        idx.serve(mode="qfdl")
    # apply() repairs dense stores of undirected graphs: a directed graph
    # (item 8) and a sharded store (item 9) are refused
    gd = interop.graph(rg.random_connected(16, extra_edges=10, seed=0,
                                           directed=True))
    with pytest.raises(NotImplementedError, match="item 8"):
        idx.apply(MutationBatch([]), graph=gd)

    class ShardedLike:
        kind = "sharded"
    sharded = CHLIndex(ShardedLike(), plan=idx.plan, report=idx.report,
                       rank=rank)
    with pytest.raises(NotImplementedError, match="item 9"):
        sharded.apply(MutationBatch([]), graph=pg)


def test_checkpointed_build_equals_plain_build(tmp_path):
    """``ckpt=`` checkpoints every committed superstep (it raised before
    checkpoints were ported) and changes no label."""
    g, rank = _case("grid")
    pg = interop.graph(g)
    mgr = CheckpointManager(str(tmp_path))
    res = run_build(pg, rank, algo="plant", batch=8, ckpt=mgr, device="cpu")
    plain = run_build(pg, rank, algo="plant", batch=8, device="cpu")
    assert mgr.all_steps() and mgr.peek()["pos"] == g.n
    assert res.resumed_from is None and plain.resumed_from is None
    for a, b in zip(res.sink.table(), plain.sink.table()):
        assert torch.equal(a, b)
    assert [r.to_dict() for r in res.records] == \
        [r.to_dict() for r in plain.records]


def test_run_build_custom_root_order():
    """The road-scale phase's entry: a custom root order and cap; the
    labels equal the reference engine's."""
    from repro.engine import run_build as ref_run_build
    g, rank = _case("grid")
    order = np.argsort(-np.diff(g.indptr), kind="stable")[:6]
    res = run_build(interop.graph(g), rank, algo="plant", batch=4, cap=6,
                    roots_order=order, device="cpu")
    ref = ref_run_build(g, rank, algo="plant", batch=4, cap=6,
                        roots_order=order)
    for a, b in zip(res.sink.table(), ref.sink.table()):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert [r.to_dict() for r in res.records] == \
        [r.to_dict() for r in ref.records]


def test_engine_helpers_match_reference():
    """Scheduler, fingerprint and the packed stats protocol."""
    from repro.engine.policies import build_fingerprint as ref_fingerprint
    from repro.engine.records import make_record as ref_make_record
    from repro.engine.scheduler import rank_order as ref_rank_order
    from repro.engine.scheduler import root_batches as ref_root_batches
    from repro_torch.engine import (build_fingerprint, fetch_stat_rows,
                                    make_record, pack_stats, rank_order,
                                    record_from_row, root_batches)
    g, rank = _case("ties")
    assert build_fingerprint(interop.graph(g), rank) == \
        ref_fingerprint(g, rank)
    order = rank_order(rank)
    assert np.array_equal(order, ref_rank_order(rank))
    for (r, v), (rr, rv) in zip(root_batches(order, 5),
                                ref_root_batches(order, 5)):
        assert np.array_equal(r, rr) and np.array_equal(v, rv)
    rows = fetch_stat_rows([pack_stats(torch.tensor(7), 30, 4),
                            pack_stats(0, torch.tensor(5))])
    assert rows.tolist() == [[7, 30, 4, 0, 0], [0, 5, -1, 0, 0]]
    assert record_from_row("plant", rows[0], trees=3).to_dict() == \
        ref_make_record("plant", labels=7, explored=30, sweeps=4,
                        trees=3).to_dict()
    assert make_record("plant", labels=0, explored=5).psi == 5.0
