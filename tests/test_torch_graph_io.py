"""Graph I/O, ``to_networkx`` and ``random_geometric`` in the port,
against the reference.

DIMACS ``.gr`` and ``.npz`` files round-trip in each package and cross
between them; ``random_geometric`` gives the reference's arrays, also
at radii small enough to leave several components, which
``_ensure_connected`` joins through the same representatives without
networkx. Every comparison is exact (``np.array_equal`` on the graph's
arrays).
"""

import os
import subprocess
import sys

import networkx as nx
import numpy as np
import pytest

import repro.graphs as rg
import repro.graphs.io as rio
from repro_torch import graphs as tg
from repro_torch.graphs import generators as tgen
from repro_torch.graphs import io as tio

ARRAYS = ("ell_src", "ell_w", "indptr", "indices", "weights")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(a, b):
    assert (a.n, a.m, a.directed) == (b.n, b.m, b.directed)
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


def graphs():
    """(port graph, reference graph) pairs from the same seeds: a road
    grid, a scale-free graph, a digraph with fractional weights."""
    out = [(tg.grid_road(5, 6, seed=1), rg.grid_road(5, 6, seed=1)),
           (tg.scale_free(40, attach=2, seed=2),
            rg.scale_free(40, attach=2, seed=2))]
    rng = np.random.default_rng(3)
    s, d = rng.integers(0, 30, 90), rng.integers(0, 30, 90)
    w = rng.integers(1, 40, 90) / 4.0
    out.append((tg.from_edges(30, s, d, w, directed=True),
                rg.from_edges(30, s, d, w, directed=True)))
    return out


@pytest.mark.parametrize("k", range(3), ids=["road", "scalefree",
                                               "directed"])
def test_dimacs_round_trip_and_cross_read(k, tmp_path):
    g, r = graphs()[k]
    pf, rf = str(tmp_path / "port.gr"), str(tmp_path / "ref.gr")
    tio.write_dimacs(g, pf)
    rio.write_dimacs(r, rf)
    with open(pf) as a, open(rf) as b:
        assert a.read() == b.read()
    for path in (pf, rf):
        back = tio.read_dimacs(path, directed=g.directed)
        assert_same(back, g)
        assert_same(back, rio.read_dimacs(path, directed=g.directed))


def test_dimacs_comments_and_one_based_ids(tmp_path):
    path = tmp_path / "tiny.gr"
    path.write_text("c a comment\np sp 4 3\nc another\n\na 1 2 3\n"
                    "a 2 3 1.5\na 4 1 2\n")
    g = tio.read_dimacs(str(path), directed=True)
    assert_same(g, rio.read_dimacs(str(path), directed=True))
    assert g.n == 4 and g.m == 3
    ids, w = g.out_edges(3)
    assert ids.tolist() == [0] and w.tolist() == [2.0]
    (tmp_path / "bad.gr").write_text("a 1 2 3\n")
    with pytest.raises(AssertionError, match="header"):
        tio.read_dimacs(str(tmp_path / "bad.gr"))


@pytest.mark.parametrize("k", range(3), ids=["road", "scalefree",
                                               "directed"])
def test_npz_round_trip_and_cross_read(k, tmp_path):
    g, r = graphs()[k]
    pf, rf = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tio.save_npz(g, pf)
    rio.save_npz(r, rf)
    for path in (pf, rf):
        assert_same(tio.load_npz(path), g)
        assert_same(rio.load_npz(path), r)


@pytest.mark.parametrize("k", range(3), ids=["road", "scalefree",
                                               "directed"])
def test_to_networkx_equals_reference(k):
    g, r = graphs()[k]
    a, b = tg.to_networkx(g), rg.to_networkx(r)
    assert type(a) is type(b)
    assert list(a.nodes) == list(b.nodes)
    assert list(a.edges(data="weight")) == list(b.edges(data="weight"))


@pytest.mark.parametrize("n,seed,radius", [
    (60, 0, None), (200, 1, None), (257, 4, None),
    (300, 2, 0.03), (400, 5, 0.02), (120, 3, 0.05), (90, 6, 0.08),
    (1, 0, None), (2, 0, 0.001)])
def test_random_geometric_equals_reference(n, seed, radius):
    assert_same(tg.random_geometric(n, radius, seed=seed),
                rg.random_geometric(n, radius, seed=seed))


def test_random_geometric_max_w_and_connected():
    g = tg.random_geometric(150, 0.04, seed=9, max_w=5)
    assert_same(g, rg.random_geometric(150, 0.04, seed=9, max_w=5))
    assert g.weights.max() < 5
    assert nx.is_connected(tg.to_networkx(g))


@pytest.mark.parametrize("n,edges,seed,not_least", [
    (300, 150, 0, 23), (400, 120, 1, 32), (100, 50, 2, 9), (64, 200, 3, 0)])
def test_components_equal_networkx_iteration_order(n, edges, seed,
                                                   not_least):
    """The port's components are networkx's, as sets iterated in the same
    order, so each representative ``next(iter(c))`` is the same; in
    ``not_least`` of them it is not the component's least vertex."""
    rng = np.random.default_rng(seed)
    g = tg.from_edges(n, rng.integers(0, n, edges), rng.integers(0, n, edges),
                      np.ones(edges, np.float32))
    mine = tgen._components(g)
    ref = list(nx.connected_components(tg.to_networkx(g)))
    assert [list(c) for c in mine] == [list(c) for c in ref]
    assert sum(next(iter(c)) != min(c) for c in mine) == not_least


def test_generators_import_no_networkx():
    code = ("import sys; sys.modules['networkx'] = None\n"
            "from repro_torch.graphs import generators, random_geometric\n"
            "g = random_geometric(200, 0.03, seed=2)\n"
            "assert g.n == 200\n"
            "print('OK')\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "OK", out.stderr
