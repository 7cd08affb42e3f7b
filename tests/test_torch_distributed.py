"""The distributed builds (DGLL, the Hybrid, distributed PLaNT) on the
port's node mesh against the reference package's ``shard_map`` mesh.

- q = 1 in process: ``tests/test_distributed.py``'s graphs and
  parameters through both packages' drivers (``run_distributed``):
  merged tables, the ``[1, n, cap]`` partitions and the stats dicts
  equal; through ``build`` the reports' supersteps too, and the default
  plan (the hybrid) builds;
- (q = 2 and q = 8 against the reference's forced-host-device child
  are in ``tests/test_torch_distributed_mesh.py``);
- the port's collective calls: none in a PLaNT superstep, at least one
  in a DGLL superstep (the reference's HLO check);
- checkpoints: a mesh step equals the reference's, manifest and arrays,
  and resumes across the packages both ways at q = 1; the port resumes
  its own q = 2 step equal to an uninterrupted run.

Weights are integral f32, so every comparison is exact.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.checkpoint import CheckpointManager as RefManager
from repro.core.dgll import assign_roots as ref_assign_roots
from repro.core.dgll import make_node_mesh as ref_mesh
from repro.core.hybrid import run_distributed as ref_run_distributed
from repro.engine import run_build as ref_run_build
from repro.graphs.ranking import degree_ranking, random_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import dgll
from repro_torch.core import labels as lbl
from repro_torch.core.dgll import merge_partitions, stack_partitions
from repro_torch.core.hybrid import run_distributed
from repro_torch.engine import run_build
from repro_torch.engine.scheduler import QueueSchedule
from repro_torch.index import BuildPlan, build
from repro_torch.parallel import NodeMesh
from repro_torch.parallel import collectives as coll

torch.set_num_threads(1)

CPU = NodeMesh(["cpu"])


def same(port_table, ref_table):
    """Array for array (dtype, shape, slot order, padding)."""
    for a, b in zip(port_table, ref_table):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            return False
    return True


STAT_KEYS = ("mode", "labels", "explored", "psi", "comm_label_slots",
             "replanted_trees", "replanted_labels", "dead_nodes", "q",
             "psi_threshold")

# tests/test_distributed.py's cases: (graph, ranker, driver kwargs)
Q1_CASES = {
    "dgll-grid": (lambda: rg.grid_road(5, 5, seed=1), degree_ranking,
                  dict(batch=4, beta=4.0, psi_threshold=0.0,
                       algo_name="dgll")),
    "dgll-ba": (lambda: rg.scale_free(40, attach=2, seed=1),
                degree_ranking,
                dict(batch=4, beta=4.0, psi_threshold=0.0,
                     algo_name="dgll")),
    "dgll-tree+": (lambda: rg.random_connected(36, extra_edges=30, seed=2),
                   lambda g: random_ranking(g.n, seed=5),
                   dict(batch=4, beta=4.0, psi_threshold=0.0,
                        algo_name="dgll")),
    "plant-dist": (lambda: rg.scale_free(42, attach=2, seed=3),
                   degree_ranking,
                   dict(batch=4, psi_threshold=float("inf"),
                        algo_name="plant-dist")),
    "hybrid-switch": (lambda: rg.grid_road(6, 6, seed=2), degree_ranking,
                      dict(batch=4, eta=4, psi_threshold=2.0)),
    "hybrid-eta0": (lambda: rg.scale_free(40, attach=2, seed=6),
                    degree_ranking, dict(eta=0, psi_threshold=3.0)),
    "hybrid-eta8": (lambda: rg.scale_free(40, attach=2, seed=6),
                    degree_ranking, dict(eta=8, psi_threshold=3.0)),
    "dgll-compact": (lambda: rg.scale_free(40, attach=2, seed=7),
                     degree_ranking,
                     dict(batch=4, beta=4.0, psi_threshold=0.0,
                          compact=16, algo_name="dgll")),
    "hybrid-compact": (lambda: rg.grid_road(6, 6, seed=9), degree_ranking,
                       dict(batch=4, eta=4, psi_threshold=2.0,
                            compact=64)),
}


def test_assign_roots_equals_reference():
    g = rg.scale_free(37, attach=2, seed=0)
    rank = degree_ranking(g)
    for q in (1, 2, 3, 8):
        assert np.array_equal(dgll.assign_roots(rank, q),
                              ref_assign_roots(rank, q))
    rank = np.array([3, 0, 2, 1, 4], dtype=np.int32)
    np.testing.assert_array_equal(dgll.assign_roots(rank, 2),
                                  [[4, 2, 1], [0, 3, -1]])


def test_queue_schedule_equals_reference():
    from repro.engine.scheduler import QueueSchedule as RefSchedule
    queues = ref_assign_roots(degree_ranking(rg.grid_road(5, 6, seed=1)),
                              3)
    for start, size in ((0, None), (3, 8)):
        port = list(QueueSchedule(queues, 2, 4.0).steps(start, size))
        ref = list(RefSchedule(queues, 2, 4.0).steps(start, size))
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            assert (a.pos, a.end, a.next_size) == (b.pos, b.end,
                                                   b.next_size)
            assert np.array_equal(a.roots, b.roots)
            assert np.array_equal(a.valid, b.valid)


@pytest.mark.parametrize("case", sorted(Q1_CASES))
def test_q1_driver_equals_reference(case):
    make, ranker, kw = Q1_CASES[case]
    g = make()
    rank = ranker(g)
    table, stats = run_distributed(interop.graph(g), rank, mesh=CPU, **kw)
    ref_table, ref_stats = ref_run_distributed(g, rank, mesh=ref_mesh(1),
                                               **kw)
    assert same(table, ref_table)
    assert same(stack_partitions(stats["partitioned"]),
                ref_stats["partitioned"])
    assert same(stats["hc"], ref_stats["hc"])
    for k in STAT_KEYS:
        assert stats[k] == ref_stats[k], k


@pytest.mark.parametrize("algo,kw", [
    ("hybrid", dict(batch=4, eta=4, psi_th=2.0)),
    ("hybrid", dict(batch=4, eta=4, psi_th=2.0, compact=64)),
    ("dgll", dict(batch=4, beta=4.0, eta=0)),
    ("plant-dist", dict(batch=4, cap=3)),       # overflows, regrows
])
def test_build_report_equals_reference(algo, kw):
    g = rg.scale_free(40, attach=2, seed=4)
    rank = degree_ranking(g)
    port = build(interop.graph(g), rank, BuildPlan(algo=algo, **kw),
                 mesh=CPU)
    ref = ref_build(g, rank, RefPlan(algo=algo, **kw), mesh=ref_mesh(1))
    assert same(port.table, ref.table)
    assert same(stack_partitions(port.partitioned), ref.partitioned)
    a, b = port.report.to_dict(), ref.report.to_dict()
    for k in ("wall_s", "notes"):
        a.pop(k), b.pop(k)
    assert a == b
    assert port.report.summary().split()[:5] == \
        ref.report.summary().split()[:5]


def test_default_plan_builds_the_hybrid():
    g = rg.grid_road(6, 7, seed=3)
    rank = degree_ranking(g)
    port = build(interop.graph(g), rank, device="cpu")
    ref = ref_build(g, rank)
    assert port.plan == BuildPlan() and port.report.algo == "hybrid"
    assert port.report.q == ref.report.q == 1
    assert same(port.table, ref.table)
    assert [r.to_dict() for r in port.report.supersteps] == \
        [r.to_dict() for r in ref.report.supersteps]
    assert port.report.psi_threshold == ref.report.psi_threshold == 12.0


def test_normalize_stats_equals_reference():
    from repro.index.report import normalize_stats as ref_normalize
    from repro_torch.index import normalize_stats
    g = rg.grid_road(6, 6, seed=2)
    rank = degree_ranking(g)
    _, stats = run_distributed(interop.graph(g), rank, mesh=CPU, batch=4,
                               eta=4, psi_threshold=2.0)
    stats = {k: v for k, v in stats.items()
             if k not in ("partitioned", "hc")}
    port, ref = normalize_stats("hybrid", stats), ref_normalize("hybrid",
                                                                stats)
    assert [s.to_dict() for s in port.pop("supersteps")] == \
        [s.to_dict() for s in ref.pop("supersteps")]
    assert port == ref
    for legacy in ({"psi": [2.0], "labels": [3], "explored": [6]},
                   {"superstep_sizes": [4, 2], "cleaned": 1}, None):
        p, r = normalize_stats("gll", legacy), ref_normalize("gll", legacy)
        assert [s.to_dict() for s in p.pop("supersteps")] == \
            [s.to_dict() for s in r.pop("supersteps")]
        assert p == r


def test_merge_partitions_equals_reference():
    from repro.core.dgll import merge_partitions as ref_merge
    from repro.core.labels import LabelTable as RefTable
    rng = np.random.default_rng(0)
    q, n, L = 3, 20, 5
    count = rng.integers(0, L + 1, (q, n)).astype(np.int32)
    live = np.arange(L)[None, None, :] < count[..., None]
    hubs = np.where(live, rng.integers(0, n, (q, n, L)), -1).astype(np.int32)
    dist = np.where(live, rng.integers(0, 9, (q, n, L)),
                    np.inf).astype(np.float32)
    parts = [lbl.LabelTable(torch.as_tensor(hubs[i]),
                            torch.as_tensor(dist[i]),
                            torch.as_tensor(count[i])) for i in range(q)]
    assert same(merge_partitions(parts),
                ref_merge(RefTable(hubs, dist, count)))


# ---------------------------------------------------- collective calls

@pytest.mark.parametrize("q", [1, 2, 8])
def test_collectives_only_in_dgll_supersteps(q):
    """The reference's HLO check, as call counts: a PLaNT superstep
    calls no collective, a DGLL superstep at least one; plant-dist
    builds call none at all."""
    g = interop.graph(rg.scale_free(40, attach=2, seed=0))
    rank = degree_ranking(g)
    mesh = NodeMesh.logical(q, "cpu")
    for algo, kw in (("plant-dist", {}), ("dgll", dict(eta=0)),
                     ("hybrid", dict(eta=4, psi_threshold=2.0)),
                     ("hybrid", dict(eta=4, psi_threshold=2.0,
                                     compact=8))):
        coll.reset_counts()
        res = run_build(g, rank, algo=algo, batch=2, beta=4.0, mesh=mesh,
                        **kw)
        calls = res.extras["collective_calls"]
        assert len(calls) == len(res.records)
        for r, c in zip(res.records, calls):
            assert (c == 0) if r.mode in ("plant", "plant-hc") else c > 0
        if algo == "plant-dist":
            assert coll.total_calls() == 0 and sum(coll.BYTES.values()) == 0
    # the superstep functions themselves, on a q-node state
    state = dgll.init_dist_state(mesh, g.n, cap=64, hc_cap=1)
    from repro_torch.engine.dist import node_graph
    graph = mesh.replicate(lambda d: node_graph(g, rank, d, 2))
    roots = dgll.assign_roots(rank, q)[:, :2]
    for plant, want in ((True, 0), (False, 1)):
        coll.reset_counts()
        fn = dgll.dgll_superstep_fn(mesh, g.n, batch=2, use_hc=False,
                                    plant_trees=plant)
        fn(state.table, state.hc, graph, roots, roots >= 0)
        assert (coll.total_calls() >= want) if want else \
            coll.total_calls() == 0


def test_collectives_are_exact_and_placed_per_node():
    xs = [torch.tensor([1.0, 5.0, -2.0]), torch.tensor([3.0, 2.0, -7.0]),
          torch.tensor([0.0, 9.0, torch.inf])]
    coll.reset_counts()
    g = coll.all_gather(xs)
    assert all(torch.equal(t, torch.stack(xs)) for t in g)
    assert all(torch.equal(t, torch.tensor([3.0, 9.0, torch.inf]))
               for t in coll.pmax(xs))
    assert all(torch.equal(t, torch.tensor([0.0, 2.0, -7.0]))
               for t in coll.pmin(xs))
    assert coll.COUNTS == {"all_gather": 1, "pmax": 1, "pmin": 1}
    assert coll.BYTES["all_gather"] == 2 * 3 * 12


def test_node_mesh():
    from repro_torch.parallel import make_node_mesh
    mesh = make_node_mesh(device="cpu")
    assert mesh.q == 1 and mesh.devices == (torch.device("cpu"),)
    assert make_node_mesh(4, device="cpu").q == 1     # one CPU device
    logical = NodeMesh.logical(3, "cpu")
    assert logical.q == 3 and logical.axis == "node"
    made = []
    vals = logical.replicate(lambda d: made.append(d) or object())
    assert len(made) == 1 and vals[0] is vals[1] is vals[2]
    with pytest.raises(ValueError):
        NodeMesh([])


# ---------------------------------------------------------- checkpoints

def _steps(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.startswith("step_"):
            with open(os.path.join(directory, name, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(directory, name, "arrays.npz")) as z:
                out[name] = (manifest, {k: z[k] for k in z.files})
    return out


DIST_CKPT = dict(algo="hybrid", batch=4, beta=2.0, eta=4,
                 psi_threshold=2.0)


def test_mesh_steps_equal_the_reference(tmp_path):
    g = rg.grid_road(6, 6, seed=2)
    rank = degree_ranking(g)
    run_build(interop.graph(g), rank, mesh=CPU,
              ckpt=CheckpointManager(str(tmp_path / "port"), keep=100),
              **DIST_CKPT)
    ref_run_build(g, rank, mesh=ref_mesh(1),
                  ckpt=RefManager(str(tmp_path / "ref"), keep=100),
                  **DIST_CKPT)
    port, ref = _steps(tmp_path / "port"), _steps(tmp_path / "ref")
    assert port and list(port) == list(ref)
    for name in port:
        (pm, pa), (rm, ra) = port[name], ref[name]
        assert pm == rm, name
        assert pm["data_state"]["sink"]["kind"] == "mesh"
        assert list(pa) == list(ra)
        for k in pa:
            assert pa[k].dtype == ra[k].dtype, k
            assert np.array_equal(pa[k], ra[k], equal_nan=True), k


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_mesh_steps_resume_across_packages(tmp_path, writer):
    """A q = 1 hybrid checkpointed by one package, interrupted after the
    Ψ switch, resumes in the other to the writer's own resume."""
    g = rg.grid_road(6, 6, seed=2)
    rank = degree_ranking(g)
    src = tmp_path / "src"
    if writer == "reference":
        mgr = RefManager(str(src), keep=100)
        full = ref_run_build(g, rank, mesh=ref_mesh(1), ckpt=mgr,
                             **DIST_CKPT)
    else:
        mgr = CheckpointManager(str(src), keep=100)
        full = run_build(interop.graph(g), rank, mesh=CPU, ckpt=mgr,
                         **DIST_CKPT)
    modes = [r.mode for r in full.records]
    keep = modes.index("dgll") + 1           # past the switch
    assert keep < len(modes)
    for s in mgr.all_steps()[keep:]:
        shutil.rmtree(os.path.join(str(src), f"step_{s:010d}"))
    shutil.copytree(src, tmp_path / "copy")
    port = run_build(interop.graph(g), rank, mesh=CPU,
                     ckpt=CheckpointManager(str(src), keep=100),
                     resume=True, **DIST_CKPT)
    ref = ref_run_build(g, rank, mesh=ref_mesh(1),
                        ckpt=RefManager(str(tmp_path / "copy"), keep=100),
                        resume=True, **DIST_CKPT)
    assert port.resumed_from == ref.resumed_from is not None
    assert same(stack_partitions(port.sink.tables), ref.sink.table)
    assert [r.to_dict() for r in port.records] == \
        [r.to_dict() for r in ref.records]
    assert port.counters == ref.counters


def test_port_resumes_its_q2_step(tmp_path):
    g = interop.graph(rg.scale_free(48, attach=2, seed=4))
    rank = degree_ranking(g)
    mesh = NodeMesh.logical(2, "cpu")
    kw = dict(DIST_CKPT, mesh=mesh)
    full = run_build(g, rank, **kw)
    mgr = CheckpointManager(str(tmp_path), keep=100)
    run_build(g, rank, ckpt=mgr, **kw)
    steps = mgr.all_steps()
    for s in steps[2:]:
        shutil.rmtree(os.path.join(str(tmp_path), f"step_{s:010d}"))
    res = run_build(g, rank, ckpt=CheckpointManager(str(tmp_path),
                                                    keep=100),
                    resume=True, **kw)
    assert res.resumed_from == steps[1]
    assert same(stack_partitions(res.sink.tables),
                stack_partitions(full.sink.tables))
    # restored records carry Ψ through the checkpoint's f32 array
    assert [(r.mode, r.labels, r.explored, r.trees, np.float32(r.psi))
            for r in res.records] == \
        [(r.mode, r.labels, r.explored, r.trees, np.float32(r.psi))
         for r in full.records]
    assert res.counters == full.counters
    # a step of another mesh size is not adopted
    other = run_build(g, rank, ckpt=CheckpointManager(str(tmp_path),
                                                      keep=100),
                      resume=True, **dict(kw, mesh=NodeMesh.logical(3,
                                                                    "cpu")))
    assert other.resumed_from is None
