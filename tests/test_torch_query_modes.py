"""The QLSN / QFDL / QDOL query modes (§6) through the port's index and
service, against the reference package in process.

(q = 8 against the reference's forced-host-device child, answers, QDOL
stores, hub partitions and memory reports, is in
``tests/test_torch_distributed_mesh.py``, whose child builds the same
hybrid.)

- ``CHLIndex.serve`` in every mode is bit-identical to qlsn through
  ``QueryService`` with the answer cache on and off, on a mesh of the
  build's size and of another; ``memory_report(q)`` equals the
  reference's and defaults to the build mesh's size; QFDL serves
  shard-native when the mesh size equals a sharded store's shard count;
  a loaded artifact serves QFDL from its rank; the refusals are the
  reference's.
"""

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.core import query as ref_query
from repro.core.dgll import make_node_mesh as ref_mesh
from repro.graphs.ranking import degree_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro.parallel.sharding import hub_partition_arrays as ref_partition
from repro_torch import interop
from repro_torch.core import query as qm
from repro_torch.core.dgll import stack_partitions
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.index.store import ShardedStore
from repro_torch.parallel import NodeMesh
from repro_torch.serve import backends

torch.set_num_threads(1)


def test_layouts_and_memory_helpers_equal_reference():
    g = rg.scale_free(60, attach=2, seed=2)
    rank = degree_ranking(g)
    port = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                 device="cpu")
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=8))
    for n, q in ((7, 1), (30, 3), (60, 8), (1000, 64)):
        for a, b in zip(qm.qdol_layout(n, q), ref_query.qdol_layout(n, q)):
            assert np.array_equal(a, b)
    assert qm.label_memory_bytes(port.table) == \
        ref_query.label_memory_bytes(ref.table)
    for q in (1, 3, 8, 64):
        assert qm.mode_memory_report(port.table, q) == \
            ref_query.mode_memory_report(ref.table, q)
        assert port.memory_report(q) == ref.memory_report(q)
    for K in (1, 3, 8):
        got = backends.partition_by_hub(port.table, rank,
                                        NodeMesh.logical(K, "cpu"))
        want = ref_partition(np.asarray(ref.table.hubs),
                             np.asarray(ref.table.dist), rank, K,
                             shard_cap=ref.table.hubs.shape[1])
        for a, b in zip(stack_partitions(got), want):
            assert np.array_equal(a.numpy(), b)


@pytest.fixture(scope="module")
def hybrid_q1():
    g = rg.scale_free(40, attach=2, seed=1)
    rank = degree_ranking(g)
    plan = dict(algo="hybrid", batch=4, eta=4, psi_th=50.0)
    port = build(interop.graph(g), rank, BuildPlan(**plan),
                 mesh=NodeMesh(["cpu"]))
    ref = ref_build(g, rank, RefPlan(**plan), mesh=ref_mesh(1))
    rng = np.random.default_rng(3)
    u = rng.integers(0, g.n, 64).astype(np.int32)
    v = rng.integers(0, g.n, 64).astype(np.int32)
    return g, port, ref, u, v


@pytest.mark.parametrize("mode", ["qlsn", "qfdl", "qdol"])
@pytest.mark.parametrize("cache", [0, 1024])
@pytest.mark.parametrize("q", [1, 3])
def test_serve_every_mode_bit_identical(hybrid_q1, mode, cache, q):
    """Each mode through ``QueryService`` (cached or not) equals qlsn and
    the reference's answers, on the build's one-node mesh and on three
    nodes (QFDL re-partitions by hub for a mesh of another size)."""
    g, port, ref, u, v = hybrid_q1
    want = np.asarray(ref.query(u, v))
    assert np.array_equal(port.query(u, v), want)
    srv = port.serve(mode=mode, mesh=NodeMesh.logical(q, "cpu"),
                     batch_size=32, cache=cache)
    for _ in range(2):                         # the second pass may hit
        srv.submit(u, v)
        assert np.array_equal(srv.flush(), want)
    if q == 1 and mode != "qlsn":
        r = ref.serve(mode=mode, mesh=ref_mesh(1), batch_size=32)
        r.submit(u, v)
        assert np.array_equal(r.flush(), want)


def test_memory_report_defaults_to_the_build_mesh(hybrid_q1):
    g, port, ref, _, _ = hybrid_q1
    assert port.memory_report() == ref.memory_report()
    idx = build(interop.graph(g), degree_ranking(g),
                BuildPlan(algo="plant-dist", batch=4),
                mesh=NodeMesh.logical(4, "cpu"))
    assert idx.report.q == 4 and len(idx.partitioned) == 4
    rep = idx.memory_report()
    assert rep["q"] == 4
    assert rep == ref.memory_report(4)       # the same labels
    assert rep["qfdl_total"] < rep["qdol_total"] < rep["qlsn_total"]


@pytest.mark.parametrize("nodes", [2, 3])
def test_qfdl_shard_native_on_matching_mesh(monkeypatch, nodes):
    """A sharded store on a mesh of its shard count serves QFDL from its
    own partitions (shard k on node k, one partial a node and `pmin`);
    on another mesh size, the stacked reduction. Both equal the
    reference's answers."""
    g = rg.scale_free(48, attach=2, seed=3)
    rank = degree_ranking(g)
    plan = dict(algo="plant", batch=8, store="sharded", shards=2)
    port = build(interop.graph(g), rank, BuildPlan(**plan), device="cpu")
    ref = ref_build(g, rank, RefPlan(**plan))
    rng = np.random.default_rng(5)
    u = rng.integers(0, g.n, 96).astype(np.int32)
    v = rng.integers(0, g.n, 96).astype(np.int32)
    want = np.asarray(ref.query(u, v))
    placed = []
    orig = ShardedStore.as_partitioned
    monkeypatch.setattr(ShardedStore, "as_partitioned",
                        lambda self, mesh: placed.append(mesh.q)
                        or orig(self, mesh))
    mesh = NodeMesh.logical(nodes, "cpu")
    fn = backends.make_answer_fn(port.store, "qfdl", mesh=mesh, rank=rank)
    assert np.array_equal(fn(torch.as_tensor(u), torch.as_tensor(v)).numpy(),
                          want)
    srv = port.serve(mode="qfdl", mesh=mesh, batch_size=32)
    srv.submit(u, v)
    assert np.array_equal(srv.flush(), want)
    assert placed == ([2, 2] if nodes == 2 else [])
    parts = port.store.as_partitioned(NodeMesh.logical(2, "cpu"))
    assert len(parts) == 2 and parts[1].hubs.shape == port.store.hubs[1].shape
    with pytest.raises(ValueError, match="shards"):
        port.store.as_partitioned(NodeMesh.logical(3, "cpu"))


def test_qfdl_from_a_loaded_artifact(tmp_path):
    """A loaded artifact has no construction-time partition: QFDL lays
    the hub partitions out from the stored rank."""
    g = rg.scale_free(40, attach=2, seed=2)
    rank = degree_ranking(g)
    idx = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    idx2 = CHLIndex.load(path, device="cpu")
    assert idx2.partitioned is None
    u = np.arange(g.n, dtype=np.int32)
    v = u[::-1].copy()
    for q in (1, 2):
        srv = idx2.serve(mode="qfdl", mesh=NodeMesh.logical(q, "cpu"),
                         batch_size=32)
        srv.submit(u, v)
        np.testing.assert_array_equal(srv.flush(), idx.query(u, v))


def test_distributed_modes_keep_the_reference_refusals(tmp_path):
    g = rg.scale_free(40, attach=2, seed=2)
    rank = degree_ranking(g)
    idx = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    spilled = CHLIndex.load(path, store="spill", device="cpu")
    for mode in ("qfdl", "qdol"):
        with pytest.raises(NotImplementedError,
                           match="a spill store serves qlsn only"):
            spilled.serve(mode=mode)
    with pytest.raises(ValueError, match="unknown query mode"):
        idx.serve(mode="bogus")
    with pytest.raises(ValueError, match="`partitioned` or `rank`"):
        backends.make_answer_fn(idx.table, "qfdl",
                                mesh=NodeMesh.logical(2, "cpu"))
    gd = interop.graph(rg.random_connected(16, extra_edges=10, seed=0,
                                           directed=True))
    didx = build(gd, degree_ranking(gd), BuildPlan(algo="directed"),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="mode='qlsn'"):
        didx.serve(mode="qfdl")


def test_repair_drops_the_construction_partition():
    from repro_torch.dynamic import EdgeDelete, MutationBatch
    g = interop.graph(rg.grid_road(5, 6, seed=1))
    rank = degree_ranking(g)
    idx = build(g, rank, BuildPlan(algo="plant-dist", batch=4),
                mesh=NodeMesh.logical(2, "cpu"))
    assert idx.partitioned is not None
    a, b = int(g.indices[g.indptr[0]]), 0
    idx.apply(MutationBatch([EdgeDelete(b, a)]), graph=g)
    assert idx.partitioned is None
    u, v = np.arange(g.n), np.arange(g.n)[::-1].copy()
    srv = idx.serve(mode="qfdl", mesh=NodeMesh.logical(2, "cpu"))
    srv.submit(u, v)
    np.testing.assert_array_equal(srv.flush(), idx.query(u, v))
