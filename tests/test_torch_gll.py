"""The shared-memory builds (GLL, LCC, paraPLL) and the PLL reference
through the port's `build` against the reference package's.

The same numpy graphs and rankings (the reference's ``test_gll.py``
cases, made by its generators and carried across with
`interop.graph`) go through both packages' ``build``; the label tables
must be equal array for array (hubs, dist and count, slot order and
padding included), and so must the superstep records, the
``cleaned``/``constructed`` counters and the overflow regrows. The
batch steps (`construct_batch`, `clean_superstep`) are held to the
reference's on a mid-build table with the cover helpers forced through
several chunks. Weights are integral f32, so every comparison is
exact: no tolerance.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.core import gll as ref_gll
from repro.core import labels as ref_lbl
from repro.engine import policies as ref_policies
from repro.engine import run_build as ref_run_build
from repro.graphs.ranking import degree_ranking, random_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro_torch import interop
from repro_torch.core import gll
from repro_torch.core import labels as lbl
from repro_torch.engine import (BatchSchedule, DenseSink, GLLPolicy,
                                PLLRefPolicy, PlantPolicy, rank_order, run,
                                run_build)
from repro_torch.index import BuildPlan, build
from repro_torch.sssp import relax

torch.set_num_threads(1)

CASES = {
    "grid": (lambda: rg.grid_road(5, 6, seed=0), degree_ranking),
    "ba": (lambda: rg.scale_free(45, attach=2, seed=0), degree_ranking),
    "geo": (lambda: rg.random_geometric(30, seed=0),
            lambda g: random_ranking(g.n, seed=3)),
    "tree+": (lambda: rg.random_connected(48, extra_edges=36, seed=0),
              degree_ranking),
}

#: (case, algo, alpha, cap): every alpha of GLL, LCC, paraPLL and the
#: PLL reference at the default cap on every case, and two caps that
#: force regrows
PLANS = [(case, algo, alpha, None) for case in CASES
         for algo, alpha in (("gll", 1.0), ("gll", 2.0), ("gll", 4.0),
                             ("gll", None), ("lcc", 4.0), ("parapll", 4.0),
                             ("pll-ref", 4.0))]
PLANS += [("grid", "gll", 2.0, 4), ("tree+", "parapll", 4.0, 5)]


def _case(name):
    make, ranker = CASES[name]
    g = make()
    return g, ranker(g)


def assert_same_table(port_table, ref_table):
    for a, b in zip(port_table, ref_table):
        a = a.cpu().numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case,algo,alpha,cap", PLANS)
def test_build_equals_reference(case, algo, alpha, cap):
    g, rank = _case(case)
    plan = dict(algo=algo, batch=8, alpha=alpha, cap=cap)
    port = build(interop.graph(g), rank, BuildPlan(**plan), device="cpu")
    ref = ref_build(g, rank, RefPlan(**plan))
    assert_same_table(port.table, ref.table)
    p, r = port.report.to_dict(), ref.report.to_dict()
    p.pop("wall_s"), r.pop("wall_s")
    assert p == r              # records, cleaned, constructed, regrows
    assert p["supersteps"]
    if cap is not None:
        assert p["overflow_events"]
    if algo in ("gll", "lcc"):
        assert port.report.cleaned > 0
        assert port.report.constructed == \
            port.report.cleaned + port.total_labels


@pytest.mark.parametrize("algo", ["gll", "lcc", "parapll"])
def test_gated_sweep_loop_builds_the_same_labels(algo, monkeypatch):
    """The card's sweep loop (frontier-gated sweeps, a fixpoint check
    every 4 sweeps) under the cover mask, run here on the plain sweep:
    the same labels as the reference, whose CPU sweep loop is ungated."""
    monkeypatch.setattr(relax, "batched_sssp_maxrank", functools.partial(
        relax.batched_sssp_maxrank, frontier_gating=True, check_every=4))
    g, rank = _case("tree+")
    port = build(interop.graph(g), rank, BuildPlan(algo=algo, batch=8),
                 device="cpu")
    ref = ref_build(g, rank, RefPlan(algo=algo, batch=8))
    assert_same_table(port.table, ref.table)


@pytest.mark.parametrize("wrapper,kw", [
    ("gll_chl", dict(alpha=2.0, plant_first_superstep=True)),
    ("gll_chl", dict(alpha=1.0, rank_queries=False)),
    ("lcc_chl", {}), ("parapll_chl", dict(cap=40))])
def test_chl_wrappers_match_reference(wrapper, kw):
    g, rank = _case("ba")
    table, stats = getattr(gll, wrapper)(interop.graph(g), rank, batch=6,
                                         device="cpu", **kw)
    ref_table, ref_stats = getattr(ref_gll, wrapper)(g, rank, batch=6, **kw)
    assert_same_table(table, ref_table)
    assert stats == ref_stats


@pytest.fixture(scope="module")
def mid_build():
    """A mid-build state of the reference: a global table of the top 4
    roots' labels, a local table of the next 8 roots' optimistic
    labels, and the batch after them (its last lane padding); the
    flush of these two batches cleans two labels."""
    g, rank = _case("ba")
    order = rank_order(rank)
    top = ref_run_build(g, rank, algo="plant", batch=8, cap=g.n,
                        roots_order=order[:4]).sink.table()
    src, w = jnp.asarray(g.ell_src), jnp.asarray(g.ell_w)
    rank_j = jnp.asarray(rank)
    empty = ref_lbl.empty(g.n, g.n)
    r1 = jnp.asarray(order[4:12].astype(np.int32))
    b1 = ref_gll.construct_batch(src, w, rank_j, r1, jnp.ones(8, bool), top,
                                 empty)
    loc, _ = ref_lbl.insert_batch(empty, r1, b1.emit, b1.dist)
    roots = np.concatenate([order[12:19], [0]]).astype(np.int32)
    valid = np.arange(8) < 7
    return dict(g=g, rank=rank, glob=top, loc=loc, roots=roots, valid=valid,
                first=b1)


def _port_table(t):
    return interop.label_table(*(np.array(x) for x in t), device="cpu")


def test_construct_and_clean_equal_reference_in_chunks(mid_build,
                                                       monkeypatch):
    s = mid_build
    g, rank = s["g"], s["rank"]
    glob, loc = _port_table(s["glob"]), _port_table(s["loc"])
    # three rows of the first axis a chunk: 3 chunks for the batch of 8,
    # 6 for the 16 stacked roots of the clean
    monkeypatch.setattr(lbl, "COVER_CHUNK_BYTES", 3 * 4 * g.n * glob.cap)
    assert lbl._chunk_rows(glob) == 3
    a = interop.graph(g)
    ell_src, ell_w = torch.as_tensor(a.ell_src), torch.as_tensor(a.ell_w)
    rank_t = interop.rank_tensor(rank, "cpu")
    port = gll.construct_batch(ell_src, ell_w, rank_t,
                               torch.as_tensor(s["roots"]),
                               torch.as_tensor(s["valid"]), glob, loc)
    ref = ref_gll.construct_batch(
        jnp.asarray(g.ell_src), jnp.asarray(g.ell_w), jnp.asarray(rank),
        jnp.asarray(s["roots"]), jnp.asarray(s["valid"]), s["glob"],
        s["loc"])
    assert np.array_equal(port.emit.numpy(), np.asarray(ref.emit))
    assert np.array_equal(port.dist.numpy(), np.asarray(ref.dist))
    assert not port.emit[7].any() and port.emit[:7].any()

    # the flush: both batches' labels in the local table
    loc_j, _ = ref_lbl.insert_batch(s["loc"], ref.roots, ref.emit, ref.dist)
    first = s["first"]
    roots = np.concatenate([np.asarray(first.roots), s["roots"]])
    emit = np.concatenate([np.asarray(first.emit), port.emit.numpy()])
    dist = np.concatenate([np.asarray(first.dist), port.dist.numpy()])
    red = gll.clean_superstep(glob, _port_table(loc_j), rank_t,
                              torch.as_tensor(roots), torch.as_tensor(emit),
                              torch.as_tensor(dist))
    ref_red = ref_gll.clean_superstep(s["glob"], loc_j, jnp.asarray(rank),
                                      jnp.asarray(roots), jnp.asarray(emit),
                                      jnp.asarray(dist))
    assert np.array_equal(red.numpy(), np.asarray(ref_red))
    assert red.any()


def test_gll_on_a_rank_prefix_equals_plant():
    """GLL cut to the top 8 roots (the schedule overridden, as the road
    phase on the card does) labels exactly what PLaNT does with that
    root order, here and in the reference."""
    g = rg.grid_road(8, 8, seed=0)
    rank = degree_ranking(g)
    pg = interop.graph(g)
    order = rank_order(rank)[:8]
    policy = GLLPolicy(pg, rank, batch=4, cap=8, device="cpu", alpha=4.0)
    policy.schedule = lambda: BatchSchedule(order, 4)
    res = run(policy, DenseSink(g.n, 8, "cpu"))
    plant = run_build(pg, rank, algo="plant", batch=4, cap=8,
                      roots_order=order, device="cpu")
    ref = ref_run_build(g, rank, algo="plant", batch=4, cap=8,
                        roots_order=order)
    for a, b, c in zip(res.sink.table(), plant.sink.table(),
                       ref.sink.table()):
        assert torch.equal(a, b) and np.array_equal(a.numpy(), np.asarray(c))
    assert res.counters["constructed"] > lbl.total_labels(res.sink.table())


def test_policy_fingerprints_and_configs_match_reference():
    g, rank = _case("grid")
    pg = interop.graph(g)
    order = rank_order(rank)[::-1]
    pairs = [
        (PlantPolicy(pg, rank, batch=4, device="cpu", roots_order=order),
         ref_policies.PlantPolicy(g, rank, batch=4, roots_order=order)),
        (GLLPolicy(pg, rank, batch=4, cap=9, device="cpu", alpha=None,
                   clean=False),
         ref_policies.GLLPolicy(g, rank, batch=4, cap=9, alpha=None,
                                clean=False)),
        (PLLRefPolicy(pg, rank, batch=4, device="cpu"),
         ref_policies.PLLRefPolicy(g, rank, batch=4))]
    for port, ref in pairs:
        assert port.fingerprint == ref.fingerprint
        assert port.config() == ref.config()
        assert port.eager_stats == ref.eager_stats


def test_engine_refusals():
    g, rank = _case("grid")
    with pytest.raises(ValueError, match="roots_order"):
        run_build(interop.graph(g), rank, algo="gll", device="cpu",
                  roots_order=rank_order(rank))


@pytest.mark.parametrize("algo", ["pll-ref", "gll", "lcc", "parapll"])
def test_build_defaults_to_the_card(algo, monkeypatch):
    """With no ``device`` the build runs on the card; without CUDA it
    raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, rank = _case("grid")
    with pytest.raises(RuntimeError, match="CUDA"):
        build(interop.graph(g), rank, BuildPlan(algo=algo))
    with pytest.raises(RuntimeError, match="CUDA"):
        run_build(interop.graph(g), rank, algo=algo)
