"""The readers of the port's own trace (`repro_torch.tracing`), on a
snapshot written by hand (no card needed)."""

import sys
from types import SimpleNamespace

import pytest

from chlbench import bench
from chlbench.tests.conftest import ROOT

READERS = ("sweep_active_edge_pct", "relax_sweep_ms", "fixpoint_check_ms")


def reader(name):
    return bench.load_module(ROOT / "chlbench" / "metrics" / f"{name}.py")


def hand_snapshot():
    def sweep(alive, edges_active, ms, edges=1000):
        return {"call": 0, "sweep": 0, "parent": 1, "batch": 0, "pos": 0,
                "device_ms": ms, "trees_alive": alive, "active_pairs": 1,
                "active_edges": edges_active, "edges": edges}

    def check(ms):
        return {"name": "relax.check", "t0_ns": 0, "t1_ns": 1,
                "parent": 1, "batch": 0, "pos": 0, "device_ms": ms}

    # folds: 4*1000 + 4*1000 + 2*1000 + 0 = 10,000; active: 4000 + 900
    # + 100 + 0 = 5,000
    sweeps = [sweep(4, 4000, 5.0), sweep(4, 900, 4.5), sweep(2, 100, 2.5),
              sweep(0, 0, 0.25)]
    checks = [check(0.5), check(0.25), check(0.75)]
    return {"spans": [{"name": "plant.step"}, {"name": "plant.relax"}]
            + checks, "sweeps": sweeps, "checks": checks}


@pytest.fixture
def recorded(monkeypatch):
    from repro_torch import tracing
    snap = hand_snapshot()
    monkeypatch.setattr(tracing, "snapshot", lambda: snap)
    return snap


def traced_run(busy_s=1.0):
    return SimpleNamespace(busy_s=busy_s)


def test_readers_on_a_hand_snapshot(recorded):
    run = traced_run()
    assert reader("sweep_active_edge_pct").read(run) == pytest.approx(50.0)
    assert reader("relax_sweep_ms").read(run) == pytest.approx(3.0625)
    assert reader("fixpoint_check_ms").read(run) == pytest.approx(0.5)


def test_rows_without_event_times_are_left_out(recorded):
    for r in recorded["sweeps"][1:] + recorded["checks"][1:]:
        r["device_ms"] = None
    run = traced_run()
    assert reader("relax_sweep_ms").read(run) == pytest.approx(5.0)
    assert reader("fixpoint_check_ms").read(run) == pytest.approx(0.5)
    for r in recorded["sweeps"] + recorded["checks"]:
        r["device_ms"] = None                    # the CPU: no events
    assert reader("relax_sweep_ms").read(run) is None
    assert reader("fixpoint_check_ms").read(run) is None
    assert reader("sweep_active_edge_pct").read(run) == pytest.approx(50.0)


@pytest.mark.parametrize("name", READERS)
def test_nothing_recorded_reads_nothing(monkeypatch, name):
    from repro_torch import tracing
    monkeypatch.setattr(tracing, "snapshot", lambda: {
        "spans": [], "sweeps": [], "checks": []})
    assert reader(name).read(traced_run()) is None


@pytest.mark.parametrize("name", READERS)
def test_a_run_without_a_device_trace_reads_nothing(recorded, name):
    assert reader(name).read(traced_run(busy_s=None)) is None


@pytest.mark.parametrize("name", READERS)
def test_a_port_without_the_recorder_reads_nothing(monkeypatch, name):
    # an older checkout, whose port has no `repro_torch.tracing`, reads
    # nothing and does not raise
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    assert reader(name).read(traced_run()) is None
