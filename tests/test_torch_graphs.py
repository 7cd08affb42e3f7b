"""The port's graph substrate against the reference package's.

Generators and rankings are numpy in both packages, so the same seeds
must give byte-identical ELL, CSR and rank arrays.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.graphs as rg
import repro.graphs.ranking as rrank
from repro_torch import graphs as tg
from repro_torch import interop

FIELDS = [f.name for f in dataclasses.fields(tg.Graph)]
#: the hub tail's fields: the reference pads its ELL to the largest
#: in-degree and has none; a port graph under the ELL cap has an empty
#: one
TAIL = ("tail_dst", "tail_src", "tail_w")

CASES = [
    ("grid_road", dict(rows=6, cols=7, seed=1)),
    ("grid_road", dict(rows=10, cols=10, seed=2, diag_frac=0.3)),
    ("scale_free", dict(n=60, attach=2, seed=3)),
    ("scale_free", dict(n=45, attach=3, seed=4, max_w=5)),
    ("random_connected", dict(n=50, extra_edges=40, seed=5)),
    ("random_connected", dict(n=40, extra_edges=30, seed=6,
                              directed=True)),
]


def assert_same_graph(a, b):
    """Port graph ``a`` equals reference graph ``b`` field by field."""
    for f in FIELDS:
        if f in TAIL:
            assert getattr(a, f).shape == (0,), f
            continue
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.tobytes() == y.tobytes(), f
        else:
            assert x == y, f


@pytest.mark.parametrize("gen,kw", CASES)
def test_generators_byte_identical(gen, kw):
    assert_same_graph(getattr(tg, gen)(**kw), getattr(rg, gen)(**kw))


def test_from_edges_dedupes_and_pads_like_reference():
    src = np.array([0, 1, 1, 2, 3, 3, 4, 4], np.int32)
    dst = np.array([1, 0, 2, 2, 4, 4, 0, 2], np.int32)
    w = np.array([5, 3, 2, 1, 7, 4, 9, 1], np.float32)
    for directed in (False, True):
        p = tg.from_edges(5, src, dst, w, directed=directed)
        r = rg.from_edges(5, src, dst, w, directed=directed)
        assert_same_graph(p, r)
        # ELL padding convention: source 0, weight +inf
        pad = ~np.isfinite(p.ell_w)
        assert (p.ell_src[pad] == 0).all()


#: arc weights past the packed sort key of `from_edges` (integers in
#: [0, 4096)): fractional, integral past the range, and ties on
#: duplicate arcs (which the packed key takes)
WEIGHTS = {
    "fractional": [5.5, 3, 2.25, 1, 7, 4.5, 9, 0.75],
    "past-4096": [5, 3, 2, 1, 7, 4, 9, 5000],
    "dup-ties": [5, 3, 2, 1, 4, 4, 9, 1],
}


@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_from_edges_weights_like_reference(weights):
    src = np.array([0, 1, 1, 2, 3, 3, 4, 4], np.int32)
    dst = np.array([1, 0, 2, 2, 4, 4, 0, 2], np.int32)
    w = np.array(WEIGHTS[weights], np.float32)
    for directed in (False, True):
        assert_same_graph(tg.from_edges(5, src, dst, w, directed=directed),
                          rg.from_edges(5, src, dst, w, directed=directed))


@pytest.mark.parametrize("frac", [False, True])
def test_from_edges_many_duplicate_arcs_like_reference(frac):
    """Thousands of arcs over 40 vertices, most of them repeated with
    other weights: the packed sort and the lexsort keep the same one."""
    rng = np.random.default_rng(int(frac))
    src = rng.integers(0, 40, 5000)
    dst = rng.integers(0, 40, 5000)
    w = rng.integers(0, 4096, 5000).astype(np.float32)
    if frac:
        w = w + rng.integers(0, 4, 5000) * 0.25
    for directed in (False, True):
        assert_same_graph(tg.from_edges(40, src, dst, w, directed=directed),
                          rg.from_edges(40, src, dst, w, directed=directed))


@pytest.mark.parametrize("gen,kw", CASES[:2] + CASES[4:5])
def test_rankings_identical(gen, kw):
    p, r = getattr(tg, gen)(**kw), getattr(rg, gen)(**kw)
    assert np.array_equal(tg.degree_ranking(p), rrank.degree_ranking(r))
    assert np.array_equal(tg.betweenness_ranking(p, samples=5, seed=2),
                          rrank.betweenness_ranking(r, samples=5, seed=2))


def test_interop_graph_and_device_arrays():
    r = rg.grid_road(5, 5, seed=0)
    p = interop.graph(r)
    assert_same_graph(p, r)
    rank = rrank.degree_ranking(r)
    a = tg.device_arrays(p, rank, device="cpu")
    assert a.ell_src.dtype == torch.int32 and a.ell_w.dtype == torch.float32
    assert a.rank.dtype == torch.int32
    assert np.array_equal(a.ell_src.numpy(), r.ell_src)
    assert np.array_equal(a.rank.numpy(), rank)
    assert np.array_equal(interop.rank_tensor(rank, "cpu").numpy(), rank)
