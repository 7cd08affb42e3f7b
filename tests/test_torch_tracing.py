"""The build path's recorder (`repro_torch.tracing`).

Imports nothing of JAX, so the card's tests run where only PyTorch is
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_tracing.py

- the recorder is on exactly while a ``torch.profiler`` session runs;
  without one a PLaNT batch leaves nothing in it;
- a PLaNT batch under a profiler records ``plant.step`` as the parent
  of its stage spans, ``relax.check`` under ``plant.relax``, and the
  batch's id and root cursor on every span;
- the per-sweep counts (trees alive, active pairs, their finite
  out-edges) equal a recount that replays the plain sweeps from the
  same roots and sums the frontier and the out-degrees by brute force,
  on the plain and the gated path, dense and windowed, with and without
  a block mask;
- recording changes no result: dist, mrank, sweeps, explored and the
  committed labels are bit-identical with and without a profiler;
- off the windowed kernel's route (the CPU), a sweep reports no
  activity mask;
- on the card (``cuda``): no program span reaches the device trace,
  every sweep and check has a positive event time, the rows of a batch
  add up to its record's sweeps and the counts equal the recount; on a
  scattered windowed layout each sweep's mask bits are its active pairs
  and the sparse sweeps take the gated fold.
"""

import math

import numpy as np
import pytest
import torch
from torch.autograd.profiler import emit_nvtx
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.engine import (DenseSink, PlantPolicy, fetch_stat_rows,
                                record_from_row)
from repro_torch.graphs import device_arrays, random_connected
from repro_torch.graphs.ranking import degree_ranking
from repro_torch.kernels.ell_relax import ell_sweep_plain, sweep_layout
from repro_torch.kernels.ell_relax.windowed import mask_pays
from repro_torch.sssp import batched_sssp_maxrank

torch.set_num_threads(1)

STEP_CHILDREN = {"plant.roots_h2d", "plant.relax", "plant.emit",
                 "sink.insert", "plant.stats"}
SPAN_NAMES = STEP_CHILDREN | {"plant.step", "relax.check"}


@pytest.fixture(autouse=True)
def clean_recorder():
    tracing.reset()
    yield
    tracing.reset()


def small_graph(seed=3, n=70, extra=90):
    g = random_connected(n, extra_edges=extra, seed=seed)
    return g, degree_ranking(g)


def policy_run(device, steps=2, seed=3, cap=32):
    """A PlantPolicy over a small graph: its outcomes and sink after
    ``steps`` batches."""
    g, rank = small_graph(seed)
    pol = PlantPolicy(g, rank, batch=4, device=device)
    sink = DenseSink(g.n, cap, device)
    outs = [pol.step(s, sink) for s in
            list(pol.schedule().steps())[:steps]]
    return outs, sink


def test_recorder_is_on_exactly_while_a_profiler_runs():
    assert not tracing.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.active()
    assert not tracing.active()


def test_nothing_is_recorded_without_a_profiler():
    policy_run("cpu")
    assert tracing.snapshot() == {"spans": [], "sweeps": [], "checks": []}


def test_plant_step_spans_nest_and_carry_the_batch():
    with profile(activities=[ProfilerActivity.CPU]):
        outs, _ = policy_run("cpu", steps=2)
    snap = tracing.snapshot()
    assert snap == tracing.snapshot()               # idempotent
    spans = snap["spans"]
    steps = [i for i, s in enumerate(spans) if s["name"] == "plant.step"]
    assert [spans[i]["parent"] for i in steps] == [None, None]
    assert [(spans[i]["batch"], spans[i]["pos"]) for i in steps] == [
        (0, 0), (1, 4)]
    for i in steps:
        kids = {s["name"] for s in spans if s["parent"] == i}
        assert kids == STEP_CHILDREN
    for s in spans:
        assert s["batch"] is not None and s["pos"] is not None
        assert s["t0_ns"] <= s["t1_ns"] and s["device_ms"] is None
        if s["parent"] is not None:
            up = spans[s["parent"]]
            assert (s["batch"], s["pos"]) == (up["batch"], up["pos"])
            assert up["t0_ns"] <= s["t0_ns"] <= s["t1_ns"] <= up["t1_ns"]
    checks = snap["checks"]
    assert checks and all(spans[c["parent"]]["name"] == "plant.relax"
                          for c in checks)
    # a check before every block of sweeps, and the last finds none
    rows = fetch_stat_rows([o.stats for o in outs])
    for b, row in enumerate(rows):
        sweeps = [r for r in snap["sweeps"] if r["batch"] == b]
        assert len(sweeps) == record_from_row("plant", row).sweeps
        assert sum(c["batch"] == b for c in checks) == len(sweeps) + 1
    tracing.reset()
    assert tracing.snapshot() == {"spans": [], "sweeps": [], "checks": []}


def replay_counts(es, ew, rank, roots, sweeps, gated, block_fn):
    """Per sweep (trees alive, active pairs, active edges) by replaying
    `ell_sweep_plain` from ``roots``: the frontier is what changed last
    sweep (all at first) plus what just unblocked, and its out-edges
    are counted from the ELL rows one by one."""
    n, deg = es.shape
    out_deg = np.zeros(n, np.int64)
    for v in range(n):
        for k in range(deg):
            if math.isfinite(float(ew[v, k])):
                out_deg[int(es[v, k])] += 1
    B = len(roots)
    ar = torch.arange(B)
    dist = torch.full((B, n), math.inf)
    dist[ar, roots] = 0.0
    mrank = torch.full((B, n), -1, dtype=torch.int32)
    mrank[ar, roots] = rank[roots]
    frontier = torch.ones((B, n), dtype=torch.bool)
    prev, rows, lifted = None, [], 0
    for _ in range(sweeps):
        blocked = torch.zeros((B, n), dtype=torch.bool)
        if block_fn is not None:
            blocked = block_fn(dist, roots)
            blocked[ar, roots] = False
        active = frontier if prev is None else frontier | (prev & ~blocked)
        lifted += int((active & ~frontier).sum())
        a = active.numpy()
        rows.append((int(a.any(axis=1).sum()), int(a.sum()),
                     int((a * out_deg[None, :]).sum())))
        hide = blocked | ~active if gated else blocked
        alive = active.any(dim=1) if gated else torch.ones(B, dtype=bool)
        prop = torch.where(hide, math.inf, dist)
        nd, nm = ell_sweep_plain(dist, mrank, prop, alive, es, ew, rank)
        frontier = (nd < dist) | (nm != mrank)
        dist, mrank, prev = nd, nm, blocked
    return rows, int(np.isfinite(ew.numpy()).sum()), lifted


ROUTES = [  # (gated, check_every, windowed, blocking)
    (False, 1, False, False),
    (True, 4, False, False),
    (True, 4, True, False),
    (False, 1, True, True),
    (True, 2, False, True),
]


def lifting_block(n, device, probe=150):
    """A block mask that lifts while the blocked vertices' states stay
    put: every tenth vertex is blocked until the tree reaches ``probe``,
    so the gated frontier must take in what just unblocked."""
    some = torch.arange(n, device=device) % 10 == 3
    return lambda dist, roots: some[None, :] & torch.isinf(
        dist[:, probe:probe + 1])


def relax_call(route, device="cpu", seed=5):
    """One fixpoint call on ``route``: (arrays, roots, block_fn, state)."""
    gated, every, windowed, blocking = route
    g, rank = small_graph(seed, n=300, extra=420)
    a = device_arrays(g, rank, device)
    layout = None
    if windowed:
        layout = sweep_layout(a.ell_src, a.ell_w, bb=3, max_window=128)
        assert layout.num_windows > 1
    roots = torch.as_tensor([0, 170, 260], device=device)
    block_fn = lifting_block(g.n, device) if blocking else None
    st = batched_sssp_maxrank(
        a.ell_src, a.ell_w, a.rank, roots, check_every=every,
        frontier_gating=gated, layout=layout, block_fn=block_fn)
    return a, roots, block_fn, st


@pytest.mark.parametrize("route", ROUTES)
def test_sweep_counts_equal_a_recount(route):
    with profile(activities=[ProfilerActivity.CPU]):
        a, roots, block_fn, st = relax_call(route)
    rows = tracing.snapshot()["sweeps"]
    want, edges, lifted = replay_counts(a.ell_src, a.ell_w, a.rank, roots,
                                        st.sweeps, route[0], block_fn)
    assert (lifted > 0) == (block_fn is not None)
    assert len(rows) == st.sweeps
    assert [r["sweep"] for r in rows] == list(range(st.sweeps))
    assert [(r["trees_alive"], r["active_pairs"], r["active_edges"])
            for r in rows] == want
    assert {r["edges"] for r in rows} == {edges}
    assert rows[0]["active_pairs"] == 3 * a.ell_src.shape[0]


@pytest.mark.parametrize("route", ROUTES)
def test_cpu_sweeps_report_no_activity_mask(route):
    """The activity mask is the windowed kernel's: a CPU fixpoint, on
    the dense and the windowed plain sweep alike, reports its per-sweep
    fields as absent (None), not as zeros."""
    with profile(activities=[ProfilerActivity.CPU]):
        relax_call(route)
    rows = tracing.snapshot()["sweeps"]
    assert rows
    for r in rows:
        assert (r["mask_bits"], r["gated_windows"], r["windows"]) == (
            None, None, None)


@pytest.mark.parametrize("route", ROUTES)
def test_recording_changes_no_result(route):
    *_, off = relax_call(route)
    with profile(activities=[ProfilerActivity.CPU]):
        *_, on = relax_call(route)
    assert tracing.snapshot()["sweeps"]
    assert torch.equal(on.dist, off.dist)
    assert torch.equal(on.mrank, off.mrank)
    assert on.sweeps == off.sweeps
    assert torch.equal(on.explored, off.explored)


def test_recording_changes_no_committed_label():
    outs_off, sink_off = policy_run("cpu", steps=3)
    with profile(activities=[ProfilerActivity.CPU]):
        outs_on, sink_on = policy_run("cpu", steps=3)
    for x, y in zip(sink_on.table(), sink_off.table()):
        assert torch.equal(x, y)
    assert np.array_equal(fetch_stat_rows([o.stats for o in outs_on]),
                          fetch_stat_rows([o.stats for o in outs_off]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the event timing and kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_recording(cuda_device):
    from torch.autograd import DeviceType
    policy_run(cuda_device, steps=1)               # builds the kernels
    relax_call(ROUTES[2], cuda_device)
    torch.cuda.synchronize()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs, _ = policy_run(cuda_device, steps=3)
        a, roots, _, st = relax_call(ROUTES[2], cuda_device)
        torch.cuda.synchronize()
    names = {e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA}
    assert names and not names & SPAN_NAMES, names
    snap = tracing.snapshot()
    for r in snap["sweeps"] + snap["checks"]:
        assert math.isfinite(r["device_ms"]) and r["device_ms"] > 0, r
    assert all(s["device_ms"] is not None for s in snap["spans"])
    rows = fetch_stat_rows([o.stats for o in outs])
    for b, row in enumerate(rows):
        assert sum(r["batch"] == b for r in snap["sweeps"]) == \
            record_from_row("plant", row).sweeps
    # the windowed call (no step: no batch) counts as the CPU replays
    last = [r for r in snap["sweeps"] if r["batch"] is None]
    assert len(last) == st.sweeps
    want, edges, _ = replay_counts(a.ell_src.cpu(), a.ell_w.cpu(),
                                a.rank.cpu(), roots.cpu(), st.sweeps,
                                True, None)
    assert [(r["trees_alive"], r["active_pairs"], r["active_edges"])
            for r in last] == want
    assert {r["edges"] for r in last} == {edges}
    # no activity mask: the batches ran the dense kernel, and the small
    # windowed layout's gathers crowd a few sectors (the mask never pays)
    assert not mask_pays(3, sweep_layout(a.ell_src, a.ell_w, bb=3,
                                         max_window=128))
    assert all(r["mask_bits"] is None for r in snap["sweeps"])


@pytest.mark.cuda
def test_card_recording_reads_the_activity_mask(cuda_device):
    """A fixpoint on the card over a scattered windowed layout (the mask
    pays) records each sweep's mask: after the first sweep a set bit is
    an active pair (prop is dist at the frontier, alive its trees), the
    first sweep's finite sources are the roots, and the early sparse
    sweeps take the gated fold; the fixpoint equals the CPU's."""
    gen = torch.Generator().manual_seed(11)
    n, deg, B = 200_000, 40, 4
    es = torch.randint(0, n, (n, deg), generator=gen, dtype=torch.int32)
    ew = torch.where(torch.rand((n, deg), generator=gen) < 0.4,
                     torch.randint(1, 9, (n, deg), generator=gen).float(),
                     torch.inf)
    rank = torch.randperm(n, generator=gen).to(torch.int32)
    roots = torch.tensor([5, 70_000, 140_000, 199_999])
    cpu = batched_sssp_maxrank(es, ew, rank, roots)
    dev = [x.to(cuda_device) for x in (es, ew, rank, roots)]
    layout = sweep_layout(dev[0], dev[1], bb=B, max_window=n // 3 + 128)
    assert layout.num_windows == 3 and mask_pays(B, layout)
    batched_sssp_maxrank(*dev, layout=layout, max_sweeps=4)  # builds
    torch.cuda.synchronize()
    tracing.reset()
    with emit_nvtx():
        st = batched_sssp_maxrank(*dev, layout=layout)
        torch.cuda.synchronize()
    rows = tracing.snapshot()["sweeps"]
    assert torch.equal(st.dist.cpu(), cpu.dist)
    assert torch.equal(st.mrank.cpu(), cpu.mrank)
    assert len(rows) == st.sweeps
    for r in rows:
        assert r["mask_bits"] == (r["active_pairs"] if r["sweep"] else B)
        assert 0 <= r["gated_windows"] <= r["windows"] == 3
    assert rows[1]["gated_windows"] == 3
