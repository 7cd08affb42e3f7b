"""Node loss on the port's node mesh against the reference package.

- ``tests/ft_dist_driver.py``'s case at q = 2, run by the reference in
  ONE module-scoped child process with forced host devices: node 1
  completes superstep 2, then goes dark; a ``HeartbeatMonitor`` of
  patience 1 declares it lost and its unfinished queue is re-PLaNTed on
  the survivor. The port's dead nodes, re-planted trees and labels and
  its per-node partitions equal the reference's, and its label sets
  equal the PLL reference's (a hybrid with common labels re-plants
  HC-pruned trees the same way);
- the lost roots and the monitor equal the reference's; the dead nodes
  travel through a checkpoint; ``reshard_state`` / ``restore_elastic``
  place a checkpoint's ``[q, ...]`` arrays on another mesh.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.core.pll import pll_undirected
from repro.ft import HeartbeatMonitor as RefMonitor
from repro.ft import lost_roots as ref_lost_roots
from repro.graphs.ranking import degree_ranking
from repro_torch import interop
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import labels as lbl
from repro_torch.core import validate
from repro_torch.core.dgll import assign_roots, stack_partitions
from repro_torch.core.hybrid import run_distributed
from repro_torch.engine import MeshTableSink
from repro_torch.ft import (HeartbeatMonitor, lost_roots, reshard_state,
                            restore_elastic)
from repro_torch.parallel import NodeMesh

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: ft_dist_driver.py's run, and a hybrid whose re-plant is HC-pruned
CASES = {
    "plant-dist": dict(batch=2, beta=2.0, eta=0,
                       psi_threshold=float("inf"), algo_name="plant-dist"),
    "hybrid": dict(batch=2, beta=2.0, eta=4, psi_threshold=1e9),
}
SILENT = {1: 2}

CHILD = r"""
import json, sys
from repro.compat import set_host_device_count
set_host_device_count(2)                       # before jax backend init
import numpy as np
from repro.core.dgll import make_node_mesh
from repro.core.hybrid import run_distributed
from repro.ft import HeartbeatMonitor
from repro.graphs import grid_road
from repro.graphs.ranking import degree_ranking
g = grid_road(8, 8, seed=3)
rank = degree_ranking(g)
mesh = make_node_mesh(2)
out = {}
for name, kw in json.loads(sys.argv[2]).items():
    mon = HeartbeatMonitor(2, patience=1)
    t, s = run_distributed(g, rank, mesh=mesh, monitor=mon,
                           silent_after={1: 2}, **kw)
    for f in ("hubs", "dist", "count"):
        out[f"{name}/part_{f}"] = np.asarray(getattr(s["partitioned"], f))
    out[f"{name}/stats"] = np.array(json.dumps(
        {k: s[k] for k in ("dead_nodes", "replanted_trees",
                           "replanted_labels", "mode", "labels",
                           "explored")}))
np.savez(sys.argv[1], **out)
print("REFERENCE_OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("elastic") / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", CHILD, str(out),
                          json.dumps(CASES)], env=env, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0 and "REFERENCE_OK" in res.stdout, \
        res.stdout + res.stderr
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def ft_graph():
    g = rg.grid_road(8, 8, seed=3)
    return g, degree_ranking(g)


@pytest.mark.parametrize("case", sorted(CASES))
def test_node_loss_replants_like_the_reference(reference, case):
    g, rank = ft_graph()
    mon = HeartbeatMonitor(2, patience=1)
    table, stats = run_distributed(interop.graph(g), rank,
                                   mesh=NodeMesh.logical(2, "cpu"),
                                   monitor=mon, silent_after=SILENT,
                                   **CASES[case])
    want = json.loads(str(reference[f"{case}/stats"]))
    assert stats["dead_nodes"] == [1]
    assert stats["replanted_trees"] > 0
    assert {k: stats[k] for k in want} == want
    part = stack_partitions(stats["partitioned"])
    for f in ("hubs", "dist", "count"):
        got = getattr(part, f).numpy()
        ref = reference[f"{case}/part_{f}"]
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f
    # the recovered labels are the CHL: the PLL reference's label sets
    validate.check_equal(lbl.to_numpy_sets(table), pll_undirected(g, rank))


def test_lost_roots_and_monitor_equal_reference():
    g, rank = ft_graph()
    for q in (2, 3):
        queues = assign_roots(rank, q)
        for lost, done in (([1], 0), ([0, q - 1], 5), ([1], 999)):
            assert np.array_equal(lost_roots(queues, lost, done),
                                  ref_lost_roots(queues, lost, done))
    port, ref = HeartbeatMonitor(3, patience=2), RefMonitor(3, patience=2)
    for step in range(1, 7):
        for node in (0, 2) if step > 2 else (0, 1, 2):
            port.report(node, step)
            ref.report(node, step)
        assert port.lost(step) == ref.lost(step)
    assert port.lost(6) == [1]


def test_dead_nodes_travel_through_a_checkpoint(tmp_path):
    """The policy's meta carries the dead nodes: a resume past the loss
    keeps node 1 dead and its counters, and lands the CHL's label sets.
    (As in the reference, a resumed run counts supersteps from 0 again
    and masks only the nodes silent by that count, so the dead node's
    last columns run once more beside their re-plant: the sets hold,
    the partitions carry the repeats.)"""
    g, rank = ft_graph()
    pg = interop.graph(g)
    mesh = NodeMesh.logical(2, "cpu")
    kw = dict(CASES["plant-dist"], mesh=mesh, silent_after=SILENT)
    full, stats = run_distributed(pg, rank, ckpt=CheckpointManager(
        str(tmp_path), keep=100), monitor=HeartbeatMonitor(2, patience=1),
        **kw)
    mgr = CheckpointManager(str(tmp_path), keep=100)
    assert mgr.peek()["policy"]["dead_nodes"] == [1]
    assert mgr.peek()["counters"]["replanted_trees"] == \
        stats["replanted_trees"]
    last = mgr.all_steps()[-1]
    shutil.rmtree(os.path.join(str(tmp_path), f"step_{last:010d}"))
    again, st2 = run_distributed(pg, rank, ckpt=CheckpointManager(
        str(tmp_path), keep=100), resume=True,
        monitor=HeartbeatMonitor(2, patience=1), **kw)
    assert st2["dead_nodes"] == [1]
    assert st2["replanted_trees"] == stats["replanted_trees"]
    assert lbl.to_numpy_sets(again) == lbl.to_numpy_sets(full) == \
        pll_undirected(g, rank)


def test_restore_elastic_places_a_checkpoint_on_another_mesh(tmp_path):
    """A q = 2 mesh step restored through ``restore_elastic``: each
    node's slice on the new mesh's devices, equal to the writer's
    partitions; ``reshard_state`` takes arrays or per-node lists."""
    g, rank = ft_graph()
    mesh = NodeMesh.logical(2, "cpu")
    _, stats = run_distributed(interop.graph(g), rank, mesh=mesh,
                               ckpt=CheckpointManager(str(tmp_path)),
                               **CASES["plant-dist"])
    mgr = CheckpointManager(str(tmp_path))
    sink = MeshTableSink(mesh, g.n, stats["partitioned"][0].cap)
    template = {"sink": sink.state_arrays(),
                "records": {"packed": np.zeros((0, 5), np.int32),
                            "psi": np.zeros(0, np.float32)}}
    state, step, data = restore_elastic(mgr, {"sink": template["sink"]},
                                        NodeMesh.logical(2, "cpu"))
    assert step == mgr.latest_step() and data["sink"]["q"] == 2
    for f in ("hubs", "dist", "count"):
        parts = state["sink"][f]
        assert len(parts) == 2
        for i in range(2):
            assert torch.equal(parts[i], getattr(stats["partitioned"][i], f))
    again = reshard_state({"x": [t.hubs for t in stats["partitioned"]]},
                          mesh)
    assert torch.equal(again["x"][1], stats["partitioned"][1].hubs)
    with pytest.raises(ValueError, match="node"):
        reshard_state(np.zeros((3, 4)), mesh)
