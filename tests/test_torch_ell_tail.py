"""The degree-capped pull ELL and its hub tail, against the reference
package (whose ELL is padded to the largest in-degree) and the
benchmark's plain reference.

1. layout: on small Graph500 Kronecker graphs (some degree past the
   cap) each row's in-edges, ELL then tail, are the reference's padded
   row in order, and the port graph is the reference's capped
   (`cap_ell`, `interop.graph`); a graph under the cap keeps the
   reference's arrays and its layout; the source-windowed layout of a
   tailed graph holds the reference layout's buckets; a tailed
   adjacency takes a layout on every device, the CPU included;
2. sweeps: the plain sweeps of ELL + tail and of its layout equal the
   reference's sweep over its uncapped ELL; PLaNT on a tailed graph,
   through a one-window layout and a forced windowed one, equals the
   reference package's trees and the benchmark's canonical labels;
3. every construction path (PLaNT, GLL, the hybrid, DGLL, distributed
   PLaNT, repair) on a tailed graph equals its build of the same arcs
   in one ELL as wide as the hub's degree, and the directed build the
   reference's; the build fingerprint covers the tail;
4. the recorder counts the tail's arcs, the block tiles and the lone
   tiles.
"""

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import jax.numpy as jnp

import repro.graphs as rg
from repro.core.plant import plant_batch as ref_plant_batch
from repro.kernels.ell_relax import ell_sweep_ref as ref_sweep_ref
from repro.engine.policies import build_fingerprint as ref_fingerprint
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro_torch import interop, tracing
from repro_torch.core.plant import plant_batch
from repro_torch.dynamic import EdgeReweight, MutationBatch
from repro_torch.engine import DenseSink
from repro_torch.engine.policies import build_fingerprint
from repro_torch.graphs import (ELL_CAP, cap_ell, device_adjacency,
                                device_arrays, from_edges)
from repro_torch.index import BuildPlan, build
from repro_torch.kernels.ell_relax import (ell_sweep_bucketed_plain,
                                           ell_sweep_plain, sweep_layout)
from repro_torch.kernels.ell_relax.layout import TILE_EDGES
from repro_torch.parallel import NodeMesh
from repro_torch.sssp import relax
from test_torch_ell_relax import assert_segments_hold_buckets

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = NodeMesh(["cpu"])


def bench_module(rel: str):
    """A benchmark file by its path (the harness imports them so)."""
    path = ROOT / "chlbench" / rel
    spec = importlib.util.spec_from_file_location(
        "tail_test_" + path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


KRON = bench_module("graphs/kron.py")
URAND = bench_module("graphs/urand.py")
DEGREE = bench_module("rankings/degree.py")
CANONICAL = bench_module("reference/canonical_labels.py")


def kron_edges(scale: int, seed: int = 27):
    return KRON.edges({"structure_seed": seed, "scale": scale,
                       "n": 1 << scale, "edge_factor": 16,
                       "initiator": {"A": 0.57, "B": 0.19, "C": 0.19}},
                      None)


def hub_edges(n=160, spokes=140, seed=0):
    """A hub joined to ``spokes`` vertices, a random path through all
    and some random edges: one row past the cap."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    src = np.concatenate([np.zeros(spokes, np.int64), perm[:-1],
                          rng.integers(0, n, n)])
    dst = np.concatenate([rng.choice(np.arange(1, n), spokes,
                                     replace=False), perm[1:],
                          rng.integers(0, n, n)])
    w = rng.integers(1, 20, len(src))
    keep = src != dst
    return (n, src[keep].astype(np.int32), dst[keep].astype(np.int32),
            w[keep].astype(np.float32))


def rows_of(ell_src, ell_w, v):
    keep = np.isfinite(ell_w[v])
    return ell_src[v][keep], ell_w[v][keep]


# ----------------------------------------------------------- 1. layout

def test_the_cap_is_a_module_constant_that_holds_urand():
    assert ELL_CAP >= 72 and ELL_CAP % 8 == 0


@pytest.mark.parametrize("scale", [10, 12])
def test_capped_rows_follow_the_reference_rows(scale):
    n, s, d, w = kron_edges(scale)
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    assert r.ell_src.shape[1] > ELL_CAP == g.ell_src.shape[1]
    assert g.tail_arcs and (np.diff(g.tail_dst) >= 0).all()
    split = np.unique(g.tail_dst)
    for v in split:
        es, ew = rows_of(g.ell_src, g.ell_w, v)
        t = g.tail_dst == v
        rs, rw = rows_of(r.ell_src, r.ell_w, v)
        assert np.array_equal(np.concatenate([es, g.tail_src[t]]), rs)
        assert np.array_equal(np.concatenate([ew, g.tail_w[t]]), rw)
    assert g.m == r.m == int(np.isfinite(g.ell_w).sum()) + g.tail_arcs
    capped = cap_ell(r.ell_src, r.ell_w)
    via = interop.graph(r)
    for name, want in zip(("ell_src", "ell_w", "tail_dst", "tail_src",
                           "tail_w"), (*capped[:2], *capped[2])):
        got = getattr(g, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(getattr(via, name), got), name
    for name in ("indptr", "indices", "weights"):
        assert np.array_equal(getattr(g, name), getattr(r, name)), name


def test_graph_under_the_cap_keeps_its_arrays_and_layout():
    """A urand-shaped graph (largest degree far under the cap) keeps the
    reference's arrays, an empty tail, and the layout its ELL alone
    gives."""
    cfg = {"structure_seed": 23, "scale": 10, "n": 1024, "edge_factor": 16}
    n, s, d, w = URAND.edges(cfg, None)
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    assert g.tail_arcs == 0 and g.ell_src.shape == r.ell_src.shape
    for name in ("ell_src", "ell_w", "indptr", "indices", "weights"):
        a, b = getattr(g, name), getattr(r, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    a = device_arrays(g, DEGREE.rank(n, s, d), "cpu")
    assert a.tail is None
    lay = sweep_layout(a.ell_src, a.ell_w, bb=4, max_window=256)
    bare = sweep_layout(torch.as_tensor(r.ell_src), torch.as_tensor(r.ell_w),
                        bb=4, max_window=256)
    for f in lay.segments._fields:
        x, y = getattr(lay.segments, f), getattr(bare.segments, f)
        assert (x == y if isinstance(x, list) else torch.equal(x, y)), f
    assert lay.counters == dict(bare.counters, tail_arcs=0, split_rows=0,
                                block_tiles=0, block_tile_edges=0,
                                lone_tiles=0, lone_tile_edges=0)


def test_tailed_layout_holds_the_reference_layout():
    """The windowed layout of ELL + tail holds the reference layout's
    buckets, built from its padded ELL: each segment lists its row's
    edges in the padded row's order."""
    import repro.kernels.ell_relax as ref_ell
    n, s, d, w = kron_edges(10)
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    es, ew, tail = device_adjacency(g, "cpu")
    lay = sweep_layout(es, ew, bb=4, max_window=256, tail=tail)
    want = ref_ell.sweep_layout(r.ell_src, r.ell_w, max_window=256)
    assert lay.num_windows == want.num_windows > 1
    assert_segments_hold_buckets(lay, want)
    assert lay.counters["tail_arcs"] == g.tail_arcs
    assert lay.counters["split_rows"] == len(np.unique(g.tail_dst))
    # the cache tells the tailed adjacency from its ELL alone
    assert sweep_layout(es, ew, bb=4, max_window=256, tail=tail) is lay
    bare = sweep_layout(es, ew, bb=4, max_window=256)
    assert bare.segments.edge_src.numel() == int(np.isfinite(g.ell_w).sum())


def test_tailed_adjacency_takes_its_layout_on_every_device():
    """With its tail a Kronecker adjacency gets a layout on the CPU too,
    of one window, holding the ELL's and the tail's arcs; without
    ``tail=`` there is none. `sweep_layout` keeps a layout built with
    the tail apart from one built without."""
    n, s, d, w = kron_edges(10)
    g = from_edges(n, s, d, w)
    es, ew, tail = device_adjacency(g, "cpu")
    assert tail is not None
    lay = relax.ell_layout(es, ew, batch=4, tail=tail)
    assert lay is not None and lay.num_windows == 1 and lay.window >= n
    assert lay.segments.edge_src.numel() == g.m
    assert lay.counters["tail_arcs"] == g.tail_arcs
    assert relax.ell_layout(es, ew, batch=4, tail=tail) is lay
    assert relax.ell_layout(es, ew, batch=4) is None
    with_tail = sweep_layout(es, ew, bb=4, max_window=256, tail=tail)
    without = sweep_layout(es, ew, bb=4, max_window=256)
    assert with_tail is not without
    assert with_tail.segments.edge_src.numel() == g.m
    assert without.counters["tail_arcs"] == 0


@pytest.mark.parametrize("windows", ["one", "several"])
def test_plain_sweeps_of_a_tailed_adjacency_equal_the_reference(windows):
    """On Kronecker states, the plain sweep of ELL + tail and the plain
    windowed sweep over the tailed layout both equal the reference
    package's sweep over its uncapped ELL; retired trees pass
    through."""
    n, s, d, w = kron_edges(10)
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    es, ew, tail = device_adjacency(g, "cpu")
    lay = (relax.ell_layout(es, ew, batch=8, tail=tail) if windows == "one"
           else sweep_layout(es, ew, bb=8, max_window=256, tail=tail))
    assert (lay.num_windows == 1) == (windows == "one")
    rng = np.random.default_rng(len(windows))
    B = 8
    dist = np.where(rng.random((B, n)) < 0.4, rng.integers(0, 9, (B, n)),
                    np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, n, (B, n)),
                     -1).astype(np.int32)
    prop = np.where(rng.random((B, n)) < 0.7, dist, np.inf).astype(
        np.float32)
    rank = rng.permutation(n).astype(np.int32)
    alive = np.arange(B) != 3
    want = [np.asarray(x) for x in ref_sweep_ref(*(jnp.asarray(x) for x in (
        dist, mrank, prop, mrank, r.ell_src, r.ell_w, rank)))]
    t = [torch.as_tensor(x) for x in (dist, mrank, prop, alive)]
    rank_t = torch.as_tensor(rank)
    for got in (ell_sweep_plain(*t, es, ew, rank_t, tail=tail),
                ell_sweep_bucketed_plain(*t, lay, rank_t)):
        for x, y, before in zip(got, want, (dist, mrank)):
            x = x.numpy()
            assert np.array_equal(x[alive], y[alive])
            assert np.array_equal(x[~alive], before[~alive])


# ----------------------------------------------------------- 2. sweeps

@pytest.mark.parametrize("route", ["one-window", "windowed"])
def test_plant_on_a_tailed_graph_equals_both_references(route):
    n, s, d, w = kron_edges(10)
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    rank = DEGREE.rank(n, s, d)
    roots = CANONICAL.top_roots(rank, 8)
    a = device_arrays(g, rank, "cpu")
    lay = (sweep_layout(a.ell_src, a.ell_w, bb=4, max_window=256,
                        tail=a.tail) if route == "windowed" else
           relax.ell_layout(a.ell_src, a.ell_w, batch=4, tail=a.tail))
    assert (lay.num_windows == 1) == (route == "one-window")
    sink = DenseSink(n, 32, torch.device("cpu"))
    valid = torch.ones(4, dtype=torch.bool)
    for lo in (0, 4):
        rb = torch.as_tensor(roots[lo:lo + 4])
        tb = plant_batch(a.ell_src, a.ell_w, a.rank, rb, valid, layout=lay)
        want = ref_plant_batch(jnp.asarray(r.ell_src), jnp.asarray(r.ell_w),
                               jnp.asarray(rank), jnp.asarray(rb.numpy()),
                               jnp.asarray(valid.numpy()))
        assert np.array_equal(tb.dist.numpy(), np.asarray(want.dist))
        assert np.array_equal(tb.emit.numpy(), np.asarray(want.emit))
        sink.insert(rb, tb.emit, tb.dist)
    got = sink.table()
    ref = CANONICAL.Reference(n, s, d, w, rank, trees=8, cap=32,
                              device="cpu").table(8)
    for x, y in zip((got.hubs, got.dist, got.count), ref):
        assert torch.equal(x, y)


# ------------------------------------------------------------ 3. paths

def hub_graphs():
    """The port's capped graph of `hub_edges`, the same arcs in one ELL
    padded to the hub's degree (the reference's, with no tail), and the
    degree ranking."""
    n, s, d, w = hub_edges()
    g, r = from_edges(n, s, d, w), rg.from_edges(n, s, d, w)
    assert g.tail_arcs and r.ell_src.shape[1] > ELL_CAP
    wide = dataclasses.replace(g, ell_src=r.ell_src, ell_w=r.ell_w,
                               **{f: v[:0] for f, v in (
                                   ("tail_dst", g.tail_dst),
                                   ("tail_src", g.tail_src),
                                   ("tail_w", g.tail_w))})
    return g, wide, DEGREE.rank(n, s, d)


@pytest.mark.parametrize("algo,kw", [
    ("plant", dict(batch=16)),
    ("gll", dict(batch=16)),
    ("hybrid", dict(batch=4, eta=4, psi_th=2.0)),
    ("dgll", dict(batch=4, beta=4.0, eta=0)),
    ("plant-dist", dict(batch=4)),
])
def test_every_build_path_reads_the_tail(algo, kw):
    """Each build of the tailed graph equals the same build of its arcs
    in one wide ELL (which every relaxation reads whole)."""
    g, wide, rank = hub_graphs()
    got, want = (build(x, rank, BuildPlan(algo=algo, **kw), mesh=CPU,
                       device="cpu") for x in (g, wide))
    for a, b in zip(got.table, want.table):
        assert torch.equal(a, b)


def test_directed_build_reads_the_tail():
    n, s, d, w = hub_edges(seed=1)
    g = from_edges(n, s, d, w, directed=True)
    r = rg.from_edges(n, s, d, w, directed=True)
    assert g.tail_arcs == 0 and g.reverse().tail_arcs  # the hub's in-arcs
    rank = DEGREE.rank(n, s, d)
    port = build(g, rank, BuildPlan(algo="directed", batch=32),
                 device="cpu")
    ref = ref_build(r, rank, RefPlan(algo="directed", batch=32))
    for a, b in ((port.l_out, ref.l_out), (port.l_in, ref.l_in)):
        for x, y in zip(a, b):
            assert np.array_equal(x.numpy(), np.asarray(y))


def test_repair_of_a_tail_arc_equals_a_rebuild():
    """Reweighting an arc that lies in the hub's tail: repair (its
    endpoint planes relax the tailed graph) gives the rebuild's
    labels."""
    g, _, rank = hub_graphs()
    v = int(g.tail_src[g.tail_dst == 0][0])
    idx = build(g, rank, BuildPlan(algo="plant", batch=8), device="cpu")
    batch = MutationBatch([EdgeReweight(0, v, 1.0)])
    rep = idx.apply(batch, graph=g)
    again = build(batch.apply(g), rank,
                  BuildPlan(algo="plant", batch=8, cap=rep.cap),
                  device="cpu")
    for (_, x), (_, y) in zip(idx.store.shard_arrays(),
                              again.store.shard_arrays()):
        for key in ("hubs", "dist", "count"):
            assert np.array_equal(np.asarray(x[key]), np.asarray(y[key]))


@pytest.mark.parametrize("path", ["plant", "gll", "hybrid", "dgll",
                                  "plant-dist", "directed", "repair"])
def test_every_build_path_passes_its_tail(path, monkeypatch):
    """Every layout a build path asks for over the hub graph's adjacency
    is built with its tail, and over an adjacency with no tail without
    one. Pruned trees seldom need the arcs into the top-ranked hub, so
    equal labels alone do not show that a path passed the tail."""
    g, _, rank = hub_graphs()
    calls = []
    real = relax.sweep_layout

    def spy(ell_src, ell_w, *, bb, tail=None, **kw):
        # the hub, vertex 0, fills its capped ELL row in a tailed graph
        full = ell_w.shape[1] == ELL_CAP and bool(
            torch.isfinite(ell_w[0]).all())
        calls.append((full, None if tail is None else tail.dst.numel()))
        return real(ell_src, ell_w, bb=bb, tail=tail, **kw)

    monkeypatch.setattr(relax, "sweep_layout", spy)
    if path == "directed":
        n, s, d, w = hub_edges(seed=1)
        dg = from_edges(n, s, d, w, directed=True)
        build(dg, DEGREE.rank(n, s, d), BuildPlan(algo="directed", batch=32),
              device="cpu")
        want = dg.reverse().tail_arcs
    elif path == "repair":
        idx = build(g, rank, BuildPlan(algo="plant", batch=8), device="cpu")
        calls.clear()
        v = int(g.tail_src[g.tail_dst == 0][0])
        idx.apply(MutationBatch([EdgeReweight(0, v, 1.0)]), graph=g)
        want = g.tail_arcs
    else:
        kw = {"plant": dict(batch=16), "gll": dict(batch=16),
              "hybrid": dict(batch=4, eta=4, psi_th=2.0),
              "dgll": dict(batch=4, beta=4.0, eta=0),
              "plant-dist": dict(batch=4)}[path]
        build(g, rank, BuildPlan(algo=path, **kw), mesh=CPU, device="cpu")
        want = g.tail_arcs
    assert any(full for full, _ in calls)
    for full, tail in calls:
        assert tail == (want if full else None)


def test_fingerprint_covers_the_tail():
    g, r, rank = hub_graphs()
    tw = g.tail_w.copy()
    tw[-1] += 1
    other = dataclasses.replace(g, tail_w=tw)
    assert np.array_equal(other.ell_w, g.ell_w)
    assert build_fingerprint(other, rank) != build_fingerprint(g, rank)
    # a graph under the cap fingerprints as the reference does
    small = rg.scale_free(40, attach=2, seed=1)
    srank = DEGREE.rank(small.n, np.repeat(np.arange(small.n),
                                           np.diff(small.indptr)),
                        small.indices)
    assert build_fingerprint(interop.graph(small), srank) == \
        ref_fingerprint(small, srank)


# ---------------------------------------------------------- 4. counters

def test_recorder_counts_the_tail_and_the_lone_tiles():
    """A star of 4,999 spokes on 5,000 vertices in two windows of 2,560,
    and 400 spokes more from vertex 1: the hub's in-edges are two
    segments past `TILE_EDGES` (2,559 and 2,440 edges), each a lone
    tile, and vertex 1's (from the hub and its 400) one of 401 edges
    past the layout's cut, a block tile that is not lone; a fixpoint
    through the CPU's one-window layout counts the tail's arcs, its two
    block tiles and its one lone tile."""
    n, mid = 5000, 400
    spokes = np.arange(1, n, dtype=np.int32)
    g = from_edges(n, np.r_[np.zeros(n - 1), np.ones(mid)].astype(np.int32),
                   np.r_[spokes, np.arange(2, 2 + mid)].astype(np.int32),
                   np.ones(n - 1 + mid, np.float32))
    assert g.tail_arcs == n - 1 - ELL_CAP + mid + 1 - ELL_CAP
    a = device_arrays(g, np.arange(n, dtype=np.int32), "cpu")
    lay = sweep_layout(a.ell_src, a.ell_w, bb=4, max_window=4096,
                       tail=a.tail)
    assert lay.num_windows == 2 and lay.window == 2560
    assert 2559 > TILE_EDGES and 2440 > TILE_EDGES
    assert lay.block_cut < mid + 1 <= TILE_EDGES
    want = {"tail_arcs": g.tail_arcs, "split_rows": 2,
            "block_tiles": 3, "block_tile_edges": n - 1 + mid + 1,
            "lone_tiles": 2, "lone_tile_edges": n - 1,
            "longest_segment": 2559}
    assert lay.counters == want
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        # a windowed call's rows (its sweeps are the card's), then a
        # plain fixpoint through the one-window layout
        rows = tracing.sweep_rows(a.ell_src, a.ell_w, lay)
        rows.open()
        rows.close(torch.ones((4, n), dtype=torch.bool))
        one = relax.ell_layout(a.ell_src, a.ell_w, batch=4, tail=a.tail)
        st = relax.batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank,
                                        torch.as_tensor([0, 1, 2, 3]),
                                        max_sweeps=1, layout=one)
    rows = tracing.snapshot()["sweeps"]
    tracing.reset()
    windowed = [r for r in rows if r["call"] == 0]
    plain = [r for r in rows if r["call"] == 1]
    assert len(windowed) == 1 and len(plain) == st.sweeps == 1
    assert {k: windowed[0][k] for k in want} == want
    assert windowed[0]["edges"] == plain[0]["edges"] == g.m
    assert windowed[0]["active_edges"] == 4 * g.m
    assert one.num_windows == 1
    assert {k: plain[0][k] for k in want} == one.counters == dict(
        want, block_tiles=2, lone_tiles=1, longest_segment=n - 1)
    # one sweep: root 1 reaches the hub through the tail's first arc,
    # the hub every spoke
    assert st.dist[1, 0] == 1 and st.dist[0, n - 1] == 1


def test_lone_segments_lead_their_windows():
    """Each window lists its segments past the layout's cut first,
    longest first (hub 40's 2,559 before hub 10's 2,298, against vertex
    order; in the second window hub 40's 2,440 before vertex 20's ~700,
    which passes the cut but not `TILE_EDGES`), then the rest by
    ascending destination, each segment's edges its row's in its
    window."""
    n = 5000
    rng = np.random.default_rng(3)
    every = np.setdiff1d(np.arange(n), [40])
    some = np.arange(1, 2300)
    some = some[some != 10]
    mid = np.arange(2600, 3300)
    extra = rng.integers(0, n, (2, 3 * n))
    src = np.concatenate([np.full(len(every), 40), np.full(len(some), 10),
                          np.full(len(mid), 20), extra[0]]).astype(np.int32)
    dst = np.concatenate([every, some, mid, extra[1]]).astype(np.int32)
    w = rng.integers(1, 9, len(src)).astype(np.float32)
    keep = src != dst
    g = from_edges(n, src[keep], dst[keep], w[keep])
    a = device_arrays(g, np.arange(n, dtype=np.int32), "cpu")
    lay = sweep_layout(a.ell_src, a.ell_w, bb=4, max_window=4096,
                       tail=a.tail)
    assert lay.num_windows == 2 and lay.counters["lone_tiles"] == 3
    assert lay.counters["block_tiles"] == 4
    s = lay.segments
    rows, length = s.seg_row.numpy(), s.seg_ptr.diff().numpy()
    for wd in range(2):
        lo, hi = s.win_segs[wd], s.win_segs[wd + 1]
        lone = length[lo:hi] > lay.block_cut
        k = int(lone.sum())
        assert k == 2 and lone[:k].all() and not lone[k:].any()
        assert (np.diff(length[lo:lo + k]) <= 0).all()
        assert (np.diff(rows[lo + k:hi]) > 0).all()
    assert rows[s.win_segs[0]:s.win_segs[0] + 2].tolist() == [40, 10]
    assert rows[s.win_segs[1]:s.win_segs[1] + 2].tolist() == [40, 20]
    assert lay.block_cut < length[s.win_segs[1] + 1] <= TILE_EDGES
    # the same arcs: each segment's edges are its row's, in its window
    seg_of = np.repeat(np.arange(len(rows)), length)
    esrc, ew = s.edge_src.numpy(), s.edge_w.numpy()
    win = np.repeat(np.searchsorted(s.win_segs, np.arange(len(rows)),
                                    side="right") - 1, length)
    assert (esrc // lay.window == win).all()
    got = np.lexsort((ew, esrc, rows[seg_of]))
    r, c = np.nonzero(np.isfinite(g.ell_w))
    want_r = np.concatenate([r, g.tail_dst])
    want_s = np.concatenate([g.ell_src[r, c], g.tail_src])
    want_w = np.concatenate([g.ell_w[r, c], g.tail_w])
    want = np.lexsort((want_w, want_s, want_r))
    assert np.array_equal(rows[seg_of][got], want_r[want])
    assert np.array_equal(esrc[got], want_s[want])
    assert np.array_equal(ew[got], want_w[want])
