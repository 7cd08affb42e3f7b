"""The distributed builds and the QLSN / QFDL / QDOL query modes (§6) on
q = 2 and q = 8 node meshes against the reference package's
``shard_map`` meshes of the same size.

The reference runs in ONE module-scoped child process with forced host
devices (``repro.compat.set_host_device_count`` before JAX starts; this
session keeps one device), on ``tests/multidevice_driver.py``'s graphs
and parameters (batch 2, beta 4, eta 8, Ψ_th 3) plus the compact
hybrid at q = 8:

- every ``[q, n, cap]`` partition, merged table and stats dict of the
  port's logical CPU mesh equals the reference's, bit for bit;
- on the q = 8 hybrid and the driver's 64 pairs, the three modes'
  answers, the QDOL layout and per-node stores, the synthesized hub
  partition and the Table-4 memory report equal the reference's.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.graphs.ranking import degree_ranking
from repro.core import query as ref_query
from repro_torch import interop
from repro_torch.core import query as qm
from repro_torch.core.dgll import stack_partitions
from repro_torch.core.hybrid import run_distributed
from repro_torch.parallel import NodeMesh
from repro_torch.serve import backends

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(port_table, ref_table):
    """Array for array (dtype, shape, slot order, padding)."""
    for a, b in zip(port_table, ref_table):
        a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        if a.dtype != b.dtype or not np.array_equal(a, b):
            return False
    return True


MD_GRAPHS = {"grid": lambda: rg.grid_road(5, 6, seed=1),
             "ba": lambda: rg.scale_free(48, attach=2, seed=4)}
#: tests/multidevice_driver.py's parameters, plus the compact hybrid
MD_ALGOS = {
    "plant-dist": dict(batch=2, eta=0, psi_threshold=float("inf"),
                       algo_name="plant-dist"),
    "dgll": dict(batch=2, beta=4.0, eta=0, psi_threshold=0.0,
                 algo_name="dgll"),
    "hybrid": dict(batch=2, eta=8, psi_threshold=3.0),
    "hybrid-compact": dict(batch=2, eta=8, psi_threshold=3.0, compact=8),
}
MD_QS = (2, 8)
#: the (q, algorithm) pairs the child builds: the compact hybrid at q = 8
MD_RUNS = [(q, algo) for q in MD_QS for algo in MD_ALGOS
           if algo != "hybrid-compact" or q == 8]

CHILD = r"""
import json, sys
from repro.compat import set_host_device_count
QS = json.loads(sys.argv[2])
set_host_device_count(max(QS))                 # before jax backend init
import numpy as np
import jax.numpy as jnp
from repro.core.dgll import make_node_mesh
from repro.core.hybrid import run_distributed
from repro.core.query import (mode_memory_report, qdol_build, qdol_fn,
                              qdol_layout, qfdl_fn, qlsn)
from repro.graphs import grid_road, scale_free
from repro.graphs.ranking import degree_ranking
from repro.serve.backends import partition_by_hub
graphs = {"grid": grid_road(5, 6, seed=1),
          "ba": scale_free(48, attach=2, seed=4)}
algos = json.loads(sys.argv[3])
runs = json.loads(sys.argv[4])
out = {}
for q in QS:
    mesh = make_node_mesh(q)
    assert mesh.devices.size == q
    for name, g in graphs.items():
        rank = degree_ranking(g)
        for algo, kw in algos.items():
            if [q, algo] not in runs:
                continue
            t, s = run_distributed(g, rank, mesh=mesh, **kw)
            key = f"{q}/{name}/{algo}"
            for f in ("hubs", "dist", "count"):
                out[f"{key}/merged_{f}"] = np.asarray(getattr(t, f))
                out[f"{key}/part_{f}"] = np.asarray(
                    getattr(s["partitioned"], f))
            out[f"{key}/stats"] = np.array(json.dumps(
                {k: s[k] for k in ("mode", "labels", "explored", "psi",
                                   "comm_label_slots", "q",
                                   "psi_threshold")}))
            if key != f"{max(QS)}/{name}/hybrid":
                continue
            # the query modes on the q = 8 hybrid
            rng = np.random.default_rng(0)
            u = rng.integers(0, g.n, 64).astype(np.int32)
            v = rng.integers(0, g.n, 64).astype(np.int32)
            uj, vj = jnp.asarray(u), jnp.asarray(v)
            out[f"{name}/u"], out[f"{name}/v"] = u, v
            out[f"{name}/qlsn"] = np.asarray(qlsn(t, uj, vj))
            out[f"{name}/qfdl"] = np.asarray(
                qfdl_fn(mesh)(s["partitioned"], uj, vj))
            layout = qdol_layout(g.n, q)
            store = qdol_build(t, layout, mesh)
            out[f"{name}/qdol"] = np.asarray(
                qdol_fn(mesh, layout)(store, uj, vj))
            for f in ("hubs", "dist", "slot"):
                out[f"{name}/qdol_{f}"] = np.asarray(getattr(store, f))
            part = partition_by_hub(t, rank, mesh)
            for f in ("hubs", "dist", "count"):
                out[f"{name}/byhub_{f}"] = np.asarray(getattr(part, f))
            out[f"{name}/memory"] = np.array(
                json.dumps(mode_memory_report(t, q)))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's q = 2 and q = 8 builds and the q = 8 hybrid's
    query modes, from one child process with forced host devices (this
    session keeps one)."""
    out = tmp_path_factory.mktemp("dist") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", CHILD, str(out),
                          json.dumps(list(MD_QS)), json.dumps(MD_ALGOS),
                          json.dumps(MD_RUNS)],
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0 and "REFERENCE_OK" in res.stdout, \
        res.stdout + res.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("graph", sorted(MD_GRAPHS))
@pytest.mark.parametrize("q,algo", MD_RUNS)
def test_mesh_equals_reference_mesh(reference, q, graph, algo):
    g = MD_GRAPHS[graph]()
    rank = degree_ranking(g)
    table, stats = run_distributed(interop.graph(g), rank,
                                   mesh=NodeMesh.logical(q, "cpu"),
                                   **MD_ALGOS[algo])
    key = f"{q}/{graph}/{algo}"
    part = stack_partitions(stats["partitioned"])
    for f in ("hubs", "dist", "count"):
        assert same([getattr(table, f)], [reference[f"{key}/merged_{f}"]])
        assert same([getattr(part, f)], [reference[f"{key}/part_{f}"]])
    want = json.loads(str(reference[f"{key}/stats"]))
    assert {k: stats[k] for k in want} == want




Q = max(MD_QS)
MESH = NodeMesh.logical(Q, "cpu")


@pytest.fixture(scope="module")
def port_q8():
    """The port's q = 8 hybrids: {graph: (graph, merged table,
    partitions)}."""
    out = {}
    for name, make in MD_GRAPHS.items():
        g = make()
        t, s = run_distributed(interop.graph(g), degree_ranking(g),
                               mesh=MESH, **MD_ALGOS["hybrid"])
        out[name] = (g, t, s["partitioned"])
    return out


@pytest.mark.parametrize("graph", sorted(MD_GRAPHS))
@pytest.mark.parametrize("mode", ["qlsn", "qfdl", "qdol"])
def test_q8_answers_equal_reference(reference, port_q8, graph, mode):
    g, table, parts = port_q8[graph]
    u = torch.as_tensor(reference[f"{graph}/u"])
    v = torch.as_tensor(reference[f"{graph}/v"])
    if mode == "qlsn":
        got = qm.qlsn(table, u, v)
    elif mode == "qfdl":
        got = qm.qfdl_fn(MESH)(parts, u, v)
    else:
        layout = qm.qdol_layout(g.n, Q)
        got = qm.qdol_fn(MESH, layout)(qm.qdol_build(table, layout, MESH),
                                       u, v)
    want = reference[f"{graph}/{mode}"]
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)
    # and every mode answers Dijkstra on these pairs
    from repro.sssp.oracle import all_pairs
    D = all_pairs(g)
    assert np.array_equal(want, D[u.numpy(), v.numpy()].astype(np.float32))


@pytest.mark.parametrize("graph", sorted(MD_GRAPHS))
def test_q8_stores_and_reports_equal_reference(reference, port_q8, graph):
    g, table, _ = port_q8[graph]
    layout = qm.qdol_layout(g.n, Q)
    ref_layout = ref_query.qdol_layout(g.n, Q)
    for a, b in zip(layout, ref_layout):
        assert np.array_equal(a, b)
    store = qm.qdol_build(table, layout, MESH)
    for f in ("hubs", "dist", "slot"):
        got = torch.stack(getattr(store, f)).numpy()
        want = reference[f"{graph}/qdol_{f}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    rank = degree_ranking(g)
    part = stack_partitions(backends.partition_by_hub(table, rank, MESH))
    for f in ("hubs", "dist", "count"):
        got = getattr(part, f).numpy()
        want = reference[f"{graph}/byhub_{f}"]
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    want = json.loads(str(reference[f"{graph}/memory"]))
    assert qm.mode_memory_report(table, Q) == want
