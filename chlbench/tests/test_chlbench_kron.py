"""The Kronecker configuration (`graphs/kron.py`, `chl_kron22`) and the
``lone_tile_edge_pct`` reader, on the CPU at test size."""

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest

from chlbench import bench
from chlbench.tests.conftest import ROOT

SEED = 2 ** 31 + 4321          # past 32 signed bits, as checks draw them


def kron(scale=12, seed=27):
    cfg = json.loads((ROOT / "chlbench/configs/chl_kron22.json")
                     .read_text())
    cfg.update(scale=scale, n=1 << scale, structure_seed=seed)
    gen = bench.load_module(ROOT / "chlbench/graphs/kron.py")
    return cfg, gen.edges(cfg, np.random.default_rng(0))


def test_the_draw_is_fixed_by_the_structure_seed():
    _, one = kron()
    _, same = kron()
    _, other = kron(seed=28)
    assert all(np.array_equal(x, y) for x, y in zip(one, same))
    assert not np.array_equal(one[1], other[1])


def test_degrees_follow_graph500():
    """At scale 12: the edge count, self loops gone, many isolated
    vertices, and a largest degree far above the mean."""
    cfg, (n, src, dst, w) = kron()
    assert n == 4096 and len(src) <= 16 * n and (src != dst).all()
    assert len(src) > 0.99 * 16 * n
    assert w.min() >= 1 and w.max() < 64 and (w == np.floor(w)).all()
    pairs = np.unique(np.concatenate([src.astype(np.int64) * n + dst,
                                      dst.astype(np.int64) * n + src]))
    deg = np.bincount(pairs // n, minlength=n)
    assert 0.1 < (deg == 0).mean() < 0.3
    assert deg.max() > 30 * deg.mean() and deg.max() > 128


def _inputs(root, seed):
    b = root / "chlbench"
    drv = bench.load_module(b / "drivers/plant_cycles.py")
    cfg = json.loads((b / "configs/chl_kron22.json").read_text())
    mix = json.loads((b / "traffic/plant-top8.json").read_text())
    return drv.inputs(b, cfg, mix, seed)


def test_the_seed_draws_only_the_sampled_rows(tiny_root):
    """Another seed serves the same graph, weights, numbering and roots
    (the configuration keeps the draw's numbering); only the rows
    compared at every cycle may differ (at test size all are)."""
    one = _inputs(tiny_root, SEED)
    other = _inputs(tiny_root, SEED + 1)
    assert all(np.array_equal(x, y) for x, y in zip(one[:6], other[:6]))
    assert len(one[6]) == one[0] == 512


@pytest.mark.parametrize("trace", [False, True])
def test_tiny_kron_cell_runs_correct(tiny_root, trace):
    """The cell at scale 9 (largest degree past the port's ELL cap, so
    its graph has a hub tail) runs correct through the harness."""
    from repro_torch.graphs import ELL_CAP, from_edges
    n, src, dst, w, *_ = _inputs(tiny_root, SEED)
    assert from_edges(n, src, dst, w).tail_arcs > 0
    assert np.bincount(np.concatenate([src, dst])).max() > ELL_CAP
    res = bench.run_cell(tiny_root, "kron-plant", SEED, 0.5, trace, "cpu",
                         time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0, res["checks"]
    assert res["attempted"] >= 1
    if not trace:
        assert set(res["metrics"]) == {"build_trees_per_s", "setup_s"}


def reader():
    return bench.load_module(ROOT / "chlbench/metrics/lone_tile_edge_pct.py")


def test_lone_tile_edge_pct_on_a_hand_snapshot(monkeypatch):
    """Two calls over two adjacencies: (3 x 300 + 2 x 0) lone edges over
    (3 x 1,000 + 2 x 500) arcs = 900 / 4,000 = 22.5 %."""
    from repro_torch import tracing

    def row(edges, lone):
        return {"edges": edges, "lone_tile_edges": lone, "device_ms": 1.0}
    snap = {"spans": [], "checks": [],
            "sweeps": [row(1000, 300)] * 3 + [row(500, 0)] * 2}
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    assert reader().read(SimpleNamespace(busy_s=1.0)) == pytest.approx(22.5)
    # no device trace, no rows, or rows of a port that counts no tiles
    assert reader().read(SimpleNamespace(busy_s=None)) is None
    snap["sweeps"] = []
    assert reader().read(SimpleNamespace(busy_s=1.0)) is None
    snap["sweeps"] = [{"edges": 1000, "device_ms": 1.0}]
    assert reader().read(SimpleNamespace(busy_s=1.0)) is None


def test_a_port_without_the_capped_ell_is_refused_before_the_draw(
        monkeypatch):
    """A port that pads its ELL to the largest in-degree cannot hold the
    hubs: the generator refuses it at once, so a run fails instead of
    being killed for memory during the build."""
    from repro_torch.graphs import graph
    monkeypatch.delattr(graph, "ELL_CAP")
    with pytest.raises(RuntimeError, match="ELL_CAP"):
        kron(scale=9)
