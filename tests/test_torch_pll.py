"""The PLL oracle, the validators and the label/oracle helpers of the
shared-memory slice against the reference package's.

The same numpy inputs go through both packages: label sets, validator
verdicts, rankings, Dijkstra planes and label tables must be equal
(tables array for array, slot order and padding included). Weights
and distances are integral f32, so every comparison is exact.
"""

import argparse

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs as rg
from repro.core import labels as ref_lbl
from repro.core import pll as ref_pll
from repro.core import query as ref_query
from repro.core import validate as ref_val
from repro.graphs import ranking as ref_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro.sssp import oracle as ref_oracle
from repro_torch import interop
from repro_torch.core import labels as lbl
from repro_torch.core import pll, query, validate
from repro_torch.graphs import ranking
from repro_torch.index import BuildPlan, build
from repro_torch.sssp import oracle

torch.set_num_threads(1)

GRAPHS = {
    "grid": lambda: rg.grid_road(5, 6, seed=1),
    "ba": lambda: rg.scale_free(40, attach=2, seed=2),
    "ties": lambda: rg.random_connected(36, 30, seed=4, max_w=3),
}


def _case(name):
    g = GRAPHS[name]()
    return g, ref_ranking.degree_ranking(g)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_pll_and_chl_by_definition_equal_reference(name):
    g, rank = _case(name)
    pg = interop.graph(g)
    sets = pll.pll_undirected(pg, rank)
    assert sets == ref_pll.pll_undirected(g, rank)
    assert pll.chl_by_definition(pg, rank) == \
        ref_pll.chl_by_definition(g, rank) == sets
    assert pll.average_label_size(sets) == ref_pll.average_label_size(sets)
    u, v = 3, g.n - 1
    assert pll.query_distance(sets, u, v) == \
        ref_pll.query_distance(sets, u, v)


def _corrupt(sets, how, rank):
    """A copy of CHL label sets broken one way."""
    out = [dict(row) for row in sets]
    top = int(np.argmax(rank))
    v = next(x for x in range(len(out)) if x != top and top in out[x])
    if how == "drop-top-hub":        # breaks cover, respects-R, equality
        del out[v][top]
    elif how == "extra-label":       # breaks minimality and equality
        far = next(h for h in range(len(out)) if h not in out[v])
        out[v][far] = 1e6
    elif how == "longer":            # an inflated distance
        out[v][top] += 1.0
    return out


@pytest.mark.parametrize("check", ["check_cover", "check_respects_r",
                                   "check_minimal", "check_equal"])
@pytest.mark.parametrize("how", ["none", "drop-top-hub", "extra-label",
                                 "longer"])
def test_validators_agree_with_reference(check, how):
    g, rank = _case("ba")
    ref_sets = ref_pll.pll_undirected(g, rank)
    sets = _corrupt(ref_sets, how, rank)
    D = ref_oracle.all_pairs(g)

    def verdict(mod, graph):
        fn = getattr(mod, check)
        args = {"check_cover": (sets, graph, D),
                "check_respects_r": (sets, graph, rank, D),
                "check_minimal": ([dict(r) for r in sets], graph, D),
                "check_equal": (sets, ref_sets)}[check]
        try:
            fn(*args)
        except AssertionError:
            return False
        return True

    got = verdict(validate, interop.graph(g))
    assert got == verdict(ref_val, g)
    # dropping a label leaves every other one necessary; a far extra
    # label covers nothing new; an inflated distance is never the min
    assert got == (how == "none" or (check, how) in {
        ("check_cover", "extra-label"), ("check_respects_r", "extra-label"),
        ("check_minimal", "drop-top-hub"), ("check_minimal", "longer")})
    assert validate.redundant_count(sets, ref_sets) == \
        ref_val.redundant_count(sets, ref_sets)


def test_rankings_and_oracles_equal_reference():
    g, rank = _case("ties")
    pg = interop.graph(g)
    for seed in (0, 3):
        assert np.array_equal(ranking.random_ranking(57, seed=seed),
                              ref_ranking.random_ranking(57, seed=seed))
    assert np.array_equal(oracle.all_pairs(pg), ref_oracle.all_pairs(g))
    for root in (0, 7, g.n - 1):
        d, m = oracle.dijkstra_maxrank(pg, root, rank)
        rd, rm = ref_oracle.dijkstra_maxrank(g, root, rank)
        assert np.array_equal(d, rd) and np.array_equal(m, rm)
    # a digraph reads its predecessors from its reverse, as the
    # reference's oracle does
    gd = rg.random_connected(20, 15, seed=1, directed=True)
    for root in (0, 11, 19):
        d, m = oracle.dijkstra_maxrank(interop.graph(gd), root, rank[:20])
        rd, rm = ref_oracle.dijkstra_maxrank(gd, root, rank[:20])
        assert np.array_equal(d, rd) and np.array_equal(m, rm)


def random_table(rng, n, L, inner_pad=False):
    """A label table with repeated hubs inside rows, counts 0..L and
    (-1, +inf) past each count; ``inner_pad`` also puts -1 slots below
    the count (which the map and the cover must skip)."""
    count = rng.integers(0, L + 1, n).astype(np.int32)
    count[0], count[1] = 0, L
    slot = np.arange(L)[None, :] < count[:, None]
    hubs = np.where(slot, rng.integers(0, n, (n, L)), -1).astype(np.int32)
    hubs[2, :2] = 5                              # a repeated hub
    if inner_pad:
        hubs[slot & (rng.random((n, L)) < 0.2)] = -1
    dist = np.where(hubs >= 0, rng.integers(0, 7, (n, L)),
                    np.inf).astype(np.float32)
    return hubs, dist, count


def both(hubs, dist, count):
    return (interop.label_table(hubs, dist, count, "cpu"),
            ref_lbl.LabelTable(jnp.asarray(hubs), jnp.asarray(dist),
                               jnp.asarray(count)))


@pytest.mark.parametrize("rows_a_chunk", [1, 2, 64])
def test_cover_helpers_equal_reference(rows_a_chunk, monkeypatch):
    rng = np.random.default_rng(rows_a_chunk)
    n, L = 24, 6
    t, rt = both(*random_table(rng, n, L, inner_pad=True))
    monkeypatch.setattr(lbl, "COVER_CHUNK_BYTES", rows_a_chunk * 4 * n * L)
    roots = np.array([2, 0, 1, 2, 7, 11, 23], np.int32)    # 2 twice
    hmap = lbl.hub_distance_map(t, torch.as_tensor(roots))
    rhmap = ref_lbl.hub_distance_map(rt, jnp.asarray(roots))
    assert np.array_equal(hmap.numpy(), np.asarray(rhmap))
    assert float(hmap[0, 5]) == float(t.dist[2, :2].min())  # the min wins
    cover = lbl.cover_distance(t, hmap)
    assert np.array_equal(cover.numpy(),
                          np.asarray(ref_lbl.cover_distance(rt, rhmap)))
    rank = rng.permutation(n).astype(np.int32)
    delta = np.where(rng.random((len(roots), n)) < 0.7,
                     rng.integers(0, 12, (len(roots), n)),
                     -np.inf).astype(np.float32)
    best = lbl.cover_best_rank(t, hmap, torch.as_tensor(rank),
                               torch.as_tensor(delta))
    ref_best = ref_lbl.cover_best_rank(rt, rhmap, jnp.asarray(rank),
                                       jnp.asarray(delta))
    assert np.array_equal(best.numpy(), np.asarray(ref_best))
    assert (best >= 0).any() and (best < 0).any()


@pytest.mark.parametrize("cap_b", [3, 9])
def test_merge_equals_reference_past_the_cap(cap_b):
    rng = np.random.default_rng(cap_b)
    a, ra = both(*random_table(rng, 20, 8))
    b, rb = both(*random_table(rng, 20, cap_b))
    merged, ovf = lbl.merge(a, b)
    ref_merged, ref_ovf = ref_lbl.merge(ra, rb)
    for x, y in zip(merged, ref_merged):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert bool(ovf) == bool(ref_ovf) is True      # row 1 is full in a
    assert np.array_equal(a.count.numpy(), np.asarray(ra.count))


def test_delete_mask_equals_reference():
    rng = np.random.default_rng(5)
    t, rt = both(*random_table(rng, 30, 7, inner_pad=True))
    drop = rng.random((30, 7)) < 0.4
    drop[1, 1:6] = True                          # interior drops
    out = lbl.delete_mask(t, torch.as_tensor(drop))
    ref = ref_lbl.delete_mask(rt, jnp.asarray(drop))
    for x, y in zip(out, ref):
        assert np.array_equal(x.numpy(), np.asarray(y))
    lbl.check_padding(out)


def test_numpy_sets_round_trip():
    rng = np.random.default_rng(7)
    t, rt = both(*random_table(rng, 25, 6, inner_pad=True))
    sets = lbl.to_numpy_sets(t)
    assert sets == ref_lbl.to_numpy_sets(rt)
    assert sets[2][5] == float(t.dist[2, :2].min())   # dedup keeps the min
    packed = lbl.from_numpy_sets(sets, device="cpu")
    ref_packed = ref_lbl.from_numpy_sets(sets)
    for x, y in zip(packed, ref_packed):
        assert np.array_equal(x.numpy(), np.asarray(y))
    assert lbl.to_numpy_sets(packed) == sets
    wide = lbl.from_numpy_sets(sets, cap=9, device="cpu")
    assert wide.cap == 9 and lbl.to_numpy_sets(wide) == sets
    with pytest.raises(lbl.LabelOverflowError):
        lbl.from_numpy_sets(sets, cap=2, device="cpu")


def test_validate_against_and_memory_report_equal_reference():
    g, rank = _case("grid")
    port = build(interop.graph(g), rank, BuildPlan(algo="gll", batch=4),
                 device="cpu")
    ref = ref_build(g, rank, RefPlan(algo="gll", batch=4))
    sets = ref_pll.pll_undirected(g, rank)
    assert port.validate_against(interop.graph(g)) is True
    assert port.validate_against(sets) is True
    assert ref.validate_against(sets) is True
    wrong = [dict(r) for r in sets]
    wrong[0].popitem()
    with pytest.raises(AssertionError):
        port.validate_against(wrong)
    for q in (None, 1, 4, 10):
        assert port.memory_report(q) == ref.memory_report(q)
    for n, q in ((30, 1), (100, 6), (1000, 28)):
        lay, ref_lay = query.qdol_layout(n, q), ref_query.qdol_layout(n, q)
        assert lay.zeta == ref_lay.zeta
        for x, y in zip(lay[1:], ref_lay[1:]):
            assert np.array_equal(x, y)
        assert query.mode_memory_totals(n, 800, q) == \
            ref_query.mode_memory_totals(n, 800, q)
    assert query.label_memory_bytes(port.table) == \
        ref_query.label_memory_bytes(ref.table)


def test_build_plan_from_args_equals_reference():
    ns = argparse.Namespace(algo="gll", batch=4, cap=None, alpha=2.0,
                            beta=None, unrelated=3)
    assert BuildPlan.from_args(ns, cap=12).to_dict() == \
        RefPlan.from_args(ns, cap=12).to_dict()
    assert BuildPlan.from_args(argparse.Namespace()).to_dict() == \
        RefPlan().to_dict()
