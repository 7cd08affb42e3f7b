"""The port's hand-written kernels on the card (skip without CUDA).

Imports nothing of JAX, so it runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

- each kernel equals its plain PyTorch version bit for bit at ragged
  shapes (the windowed sweep at 2 to 7 forced windows, B not a
  multiple of a block's trees, a hub row longer than a tile's edge
  buffer, an empty window, retired trees);
- a PLaNT build on the card (kernel path: gated sweeps, stride 4)
  gives the same label table and answers as the CPU build (plain path:
  ungated, stride 1), and its main path launches the dense sweep and
  the query kernel, not the windowed one; with an L2 that forces
  windows it launches only the windowed sweep and still equals the CPU
  build;
- GLL and LCC builds on the card (the relaxation kernels under the
  distance-query cover mask, dense and windowed) equal the CPU builds,
  and the chunked cover helpers equal one unchunked call;
- dense-block PLaNT on the card equals the ELL engine;
- the dense sweep at shapes that take each tree-group size G of its
  launch geometry, with all-padding rows, rows past the shared-memory
  edge buffer, one tree alive and none; the (min, +) product at B and
  K, N ragged around its output tile and its K stage, with ties across
  stages and all-unreachable columns;
- the label query in its table form (``query_table``: one launch that
  reads the rows itself, bounded by each row's count) and its operand
  form, each equal to the plain version at widths around every group
  size and the short/long split, counts 0..L, repeated hubs, ties,
  disjoint rows, u == v and negative ids, and past the 1,024 slots a
  warp stages at once; one launch and no other kernel per
  ``query_table`` call; an id out of range is a device-side fault;
- the two-table form (a directed query: u's rows from ``L_out``, v's
  from ``L_in``) equals the plain version in one launch; a sharded
  store's stacked query (one launch a shard, then a minimum over the
  shards) equals the dense query and takes the lowest shard's hub on a
  tie; directed and sharded builds on the card equal the CPU's;
- spill and compressed stores on the card (rows gathered, decoded for a
  compressed store, then one operand-form launch a shard) equal the
  same stores on the CPU, dist and hub, for every codec, stacked and
  routed; the u8/u16/u32 code gathers and decoders on the card equal
  numpy's (u32 codes past 2^24 included); a compressed card build
  equals the CPU's encoded shards.
"""

import copy
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import labels
from repro_torch.graphs import grid_road, random_connected
from repro_torch.graphs.ranking import degree_ranking
from repro_torch.index import BuildPlan, build
from repro_torch.graphs import scale_free
from repro_torch.kernels.ell_relax import KERNEL as ELL_RELAX
from repro_torch.kernels.ell_relax import (WINDOWED_KERNEL, ell_relax,
                                           ell_relax_windowed,
                                           ell_sweep_bucketed_plain,
                                           ell_sweep_plain, sweep_layout)
from repro_torch.kernels.ell_relax import layout as port_layout
from repro_torch.kernels.ell_relax.ell_relax import (EDGE_SLOTS, TILE_V,
                                                     launch_geometry)
from repro_torch.kernels.cuda import sm_count
from repro_torch.kernels.label_query import KERNEL as LABEL_QUERY
from repro_torch.kernels.label_query import label_query, query_table
from repro_torch.kernels.minplus import KERNEL as MINPLUS
from repro_torch.kernels.minplus import (dense_weights, minplus,
                                         minplus_plain,
                                         plant_fixpoint_dense)
from repro_torch.sssp import batched_sssp_maxrank

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card for the hand-written kernels")
    return torch.device("cuda")


def sweep_state(rng, B, n, deg, device):
    dist = np.where(rng.random((B, n)) < 0.5,
                    rng.integers(0, 9, (B, n)), np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 99, (B, n)),
                     -1).astype(np.int32)
    prop = np.where(rng.random((B, n)) < 0.7, dist,
                    np.inf).astype(np.float32)
    alive = rng.random(B) < 0.7
    ell_src = rng.integers(0, n, (n, deg)).astype(np.int32)
    ell_w = np.where(rng.random((n, deg)) < 0.4,
                     rng.integers(1, 9, (n, deg)),
                     np.inf).astype(np.float32)
    rank = rng.permutation(n).astype(np.int32)
    return [torch.as_tensor(x, device=device)
            for x in (dist, mrank, prop, alive, ell_src, ell_w, rank)]


@pytest.mark.parametrize("B,n,deg", [(1, 1, 1), (4, 333, 3), (32, 1000, 40),
                                     (5, 4097, 8)])
def test_ell_relax_equals_plain(cuda_device, B, n, deg):
    state = sweep_state(np.random.default_rng(B + n), B, n, deg,
                        cuda_device)
    kd, km = ell_relax(*state)
    pd, pm = ell_sweep_plain(*state)
    assert torch.equal(kd, pd) and torch.equal(km, pm)


@pytest.mark.parametrize("L,Q", [(8, 100), (288, 64), (700, 40)])
def test_label_query_equals_plain(cuda_device, L, Q):
    rng = np.random.default_rng(L)
    n = 40
    count = rng.integers(0, L + 1, n).astype(np.int32)
    count[::9] = 0
    slot = np.arange(L)[None, :] < count[:, None]
    h = np.where(slot, rng.integers(0, 12, (n, L)), -1).astype(np.int32)
    d = np.where(slot, rng.integers(0, 5, (n, L)),
                 np.inf).astype(np.float32)
    t = interop.label_table(h, d, count, cuda_device)
    u = torch.as_tensor(rng.integers(0, n, Q), device=cuda_device)
    v = torch.as_tensor(rng.integers(0, n, Q), device=cuda_device)
    kd, kh = query_table(t, u, v)
    pd, ph = labels.query_pairs(t, u, v)
    assert torch.equal(kd, pd) and torch.equal(kh, ph)


@pytest.mark.parametrize("kind", ["grid", "ties"])
def test_build_on_card_equals_cpu_build(cuda_device, kind):
    g = (grid_road(9, 9, seed=1) if kind == "grid"
         else random_connected(60, 50, seed=3, max_w=3))
    rank = degree_ranking(g)
    kernels = [ELL_RELAX, LABEL_QUERY]
    for k in kernels + [WINDOWED_KERNEL]:
        k.launches = 0
    card = build(g, rank, BuildPlan(algo="plant", batch=8),
                 device=cuda_device)
    cpu = build(g, rank, BuildPlan(algo="plant", batch=8), device="cpu")
    for a, b in zip(card.table, cpu.table):
        assert torch.equal(a.cpu(), b)
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, g.n, 200), rng.integers(0, g.n, 200)
    cd, ch = card.query_with_hub(u, v)
    pd, ph = cpu.query_with_hub(u, v)
    assert np.array_equal(cd, pd) and np.array_equal(ch, ph)
    srv = card.serve(batch_size=64)
    srv.submit(u, v)
    assert np.array_equal(srv.flush(), cd)
    assert all(k.launches > 0 for k in kernels)
    # one window of the card's L2 covers these graphs: the dense route
    assert WINDOWED_KERNEL.launches == 0
    assert card.report.notes == []


#: a hub row whose in-edges in one window pass a tile's edge buffer
HUB_N = 2 * port_layout.TILE_EDGES + 512


def windowed_state(rng, B, n, deg, windows, kind, device):
    """`sweep_state` and a layout of ``windows`` forced source windows.
    ``kind``: "random"; "hub" (row 7 takes its whole ELL row from the
    first window, past the tile's edge buffer); "gap" (no source in
    window 1); "retired" (only tree 1 alive); "dead" (no tree alive)."""
    state = sweep_state(rng, B, n, deg, "cpu")
    n_bn = -(-n // 128) * 128
    mw = -(-(-(-n_bn // windows)) // 128) * 128     # the cap for `windows`
    if kind == "hub":
        state[4][7] = torch.arange(deg, dtype=torch.int32)
        state[5][7] = torch.as_tensor(rng.integers(1, 9, deg),
                                      dtype=torch.float32)
    elif kind == "gap":
        es = state[4]
        state[4] = torch.where((es >= mw) & (es < 2 * mw), es - mw, es)
    elif kind in ("retired", "dead"):
        state[3][:] = False
        state[3][1] = kind == "retired"
    state = [x.to(device) for x in state]
    return state, sweep_layout(state[4], state[5], bb=B, max_window=mw)


@pytest.mark.parametrize("B,n,deg,windows,kind", [
    (1, 300, 1, 3, "random"), (4, 333, 17, 3, "random"),
    (32, 777, 40, 7, "random"), (4, 4097, 8, 2, "random"),
    (3, 1000, 8, 3, "random"), (5, 2000, 6, 4, "random"),
    (33, 700, 12, 3, "random"), (4, HUB_N, HUB_N // 2, 2, "hub"),
    (5, 1000, 8, 4, "gap"), (5, 1000, 8, 3, "retired"),
    (4, 500, 8, 2, "dead")])
def test_ell_relax_windowed_equals_plain(cuda_device, B, n, deg, windows,
                                         kind):
    state, lay = windowed_state(np.random.default_rng(B * n), B, n, deg,
                                windows, kind, cuda_device)
    assert lay.num_windows == windows
    s = lay.segments
    tile_edges = s.seg_ptr[s.tile_segs].diff()
    assert bool((tile_edges > port_layout.TILE_EDGES).any()) == (
        kind == "hub")
    if kind == "gap":
        assert s.win_tiles[1] == s.win_tiles[2]
    kd, km = ell_relax_windowed(*state[:4], lay, state[6])
    pd, pm = ell_sweep_bucketed_plain(*state[:4], lay, state[6])
    assert torch.equal(kd, pd) and torch.equal(km, pm)
    dd, dm = ell_relax(*state)
    assert torch.equal(kd, dd) and torch.equal(km, dm)


@pytest.mark.parametrize("B,K,N", [(1, 1, 1), (3, 5, 7), (64, 130, 250),
                                   (70, 333, 65)])
def test_minplus_equals_plain(cuda_device, B, K, N):
    rng = np.random.default_rng(B + K + N)
    dist = np.where(rng.random((B, K)) < 0.6, rng.integers(0, 10, (B, K)),
                    np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 100, (B, K)),
                     -1).astype(np.int32)
    w = np.where(rng.random((K, N)) < 0.3, rng.integers(1, 10, (K, N)),
                 np.inf).astype(np.float32)
    ops = [torch.as_tensor(x, device=cuda_device) for x in (dist, mrank, w)]
    kd, km = minplus(*ops)
    pd, pm = minplus_plain(*ops)
    assert torch.equal(kd, pd) and torch.equal(km, pm)


def test_windowed_build_on_card_equals_cpu_build(cuda_device, monkeypatch):
    g = random_connected(700, 600, seed=5, max_w=4)
    rank = degree_ranking(g)
    cpu = build(g, rank, BuildPlan(algo="plant", batch=8), device="cpu")
    # an L2 whose half holds 256 vertices of 8 trees' planes: 3 windows
    monkeypatch.setattr(port_layout, "l2_bytes",
                        lambda device: 2 * 8 * 8 * 256)
    ELL_RELAX.launches = WINDOWED_KERNEL.launches = 0
    card = build(g, rank, BuildPlan(algo="plant", batch=8),
                 device=cuda_device)
    assert WINDOWED_KERNEL.launches > 0 and ELL_RELAX.launches == 0
    assert any("source-windowed" in x and "num_windows=3" in x
               for x in card.report.notes)
    for a, b in zip(card.table, cpu.table):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("algo,windows", [("gll", False), ("lcc", False),
                                          ("gll", True)])
def test_shared_memory_build_on_card_equals_cpu_build(cuda_device, algo,
                                                      windows, monkeypatch):
    """GLL and LCC on the card (gated sweeps under the cover mask,
    stride 4; with ``windows`` an L2 that forces 3 source windows)
    equal the CPU build (plain, ungated) array for array."""
    g = random_connected(300, 260, seed=7, max_w=3)
    rank = degree_ranking(g)
    plan = BuildPlan(algo=algo, batch=8, alpha=2.0)
    cpu = build(g, rank, plan, device="cpu")
    if windows:
        monkeypatch.setattr(port_layout, "l2_bytes",
                            lambda device: 2 * 8 * 8 * 128)
    for k in (ELL_RELAX, WINDOWED_KERNEL, LABEL_QUERY):
        k.launches = 0
    card = build(g, rank, plan, device=cuda_device)
    for a, b in zip(card.table, cpu.table):
        assert torch.equal(a.cpu(), b)
    c, p = card.report.to_dict(), cpu.report.to_dict()
    for r in (c, p):
        r.pop("wall_s"), r.pop("notes")
    assert c == p and card.report.cleaned > 0
    sweeps = WINDOWED_KERNEL if windows else ELL_RELAX
    idle = ELL_RELAX if windows else WINDOWED_KERNEL
    assert sweeps.launches > 0 and idle.launches == 0
    u = np.arange(g.n)
    assert np.array_equal(card.query(u, u[::-1]), cpu.query(u, u[::-1]))
    assert LABEL_QUERY.launches > 0


def test_cover_best_rank_in_chunks_on_card(cuda_device, monkeypatch):
    """`cover_best_rank` and `cover_distance` at a budget of 3 rows a
    chunk equal one unchunked call on the card."""
    rng = np.random.default_rng(3)
    n, L, B = 500, 24, 11
    count = rng.integers(0, L + 1, n).astype(np.int32)
    slot = np.arange(L)[None, :] < count[:, None]
    h = np.where(slot, rng.integers(0, n, (n, L)), -1).astype(np.int32)
    d = np.where(slot, rng.integers(0, 9, (n, L)), np.inf).astype(np.float32)
    t = interop.label_table(h, d, count, cuda_device)
    roots = torch.as_tensor(rng.integers(0, n, B), device=cuda_device)
    rank = torch.as_tensor(rng.permutation(n).astype(np.int32),
                           device=cuda_device)
    delta = torch.as_tensor(rng.integers(0, 16, (B, n)).astype(np.float32),
                            device=cuda_device)
    hmap = labels.hub_distance_map(t, roots)
    whole = (labels.cover_best_rank(t, hmap, rank, delta),
             labels.cover_distance(t, hmap))
    monkeypatch.setattr(labels, "COVER_CHUNK_BYTES", 3 * 4 * n * L)
    chunked = (labels.cover_best_rank(t, hmap, rank, delta),
               labels.cover_distance(t, hmap))
    for a, b in zip(chunked, whole):
        assert torch.equal(a, b)
    assert (whole[0] >= 0).any() and torch.isfinite(whole[1]).any()
    cpu = labels.LabelTable(*(x.cpu() for x in t))
    assert torch.equal(whole[0].cpu(), labels.cover_best_rank(
        cpu, hmap.cpu(), rank.cpu(), delta.cpu()))


def test_dense_plant_on_card_equals_ell_engine(cuda_device):
    g = scale_free(300, attach=2, seed=3)
    rank = torch.as_tensor(degree_ranking(g), device=cuda_device)
    roots = torch.arange(16, device=cuda_device)
    MINPLUS.launches = 0
    dist, mrank, emit = plant_fixpoint_dense(
        dense_weights(g, cuda_device), rank, roots)
    assert MINPLUS.launches > 0
    ell_src = torch.as_tensor(g.ell_src, device=cuda_device)
    ell_w = torch.as_tensor(g.ell_w, device=cuda_device)
    st = batched_sssp_maxrank(ell_src, ell_w, rank, roots)
    assert torch.equal(dist, st.dist) and torch.equal(mrank, st.mrank)
    assert torch.equal(emit, (st.mrank == rank[roots][:, None])
                       & torch.isfinite(st.dist))


def test_new_wrappers_refuse_wrong_dtypes(cuda_device):
    state = sweep_state(np.random.default_rng(1), 2, 300, 3, cuda_device)
    lay = sweep_layout(state[4], state[5], bb=2, max_window=128)
    with pytest.raises(ValueError, match="float32"):
        ell_relax_windowed(state[0].double(), *state[1:4], lay, state[6])
    with pytest.raises(ValueError, match="int32"):
        ell_relax_windowed(*state[:4], lay, state[6].long())
    # edges that do not start on a 16-byte boundary
    s = lay.segments
    shifted = torch.empty(s.edge_src.numel() + 1, dtype=torch.int32,
                          device=cuda_device)[1:]
    shifted.copy_(s.edge_src)
    odd = copy.copy(lay)
    odd.segments = s._replace(edge_src=shifted)
    with pytest.raises(ValueError, match="16-byte"):
        ell_relax_windowed(*state[:4], odd, state[6])
    d = torch.zeros(3, 4, device=cuda_device)
    m = torch.zeros(3, 4, dtype=torch.int32, device=cuda_device)
    w = torch.zeros(4, 5, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        minplus(d.double(), m, w)
    with pytest.raises(ValueError, match="int32"):
        minplus(d, m.long(), w)
    with pytest.raises(ValueError, match="shape"):
        minplus(d, m, w[:3])
    with pytest.raises(ValueError, match="CUDA"):
        minplus(d, m, w.cpu())


@pytest.mark.parametrize("B,n,deg,kind,G", [
    (1, 5000, 8, "random", 1), (3, 777, 17, "random", 1),
    (16, 4096, 8, "random", 1), (33, 1000, 8, "random", 1),
    (4, 540_000, 8, "random", 1), (4, 541_000, 8, "random", 2),
    (3, 1_200_000, 4, "random", 2), (16, 150_000, 8, "random", 2),
    (16, 300_000, 8, "random", 4), (5, 3000, 40, "random", 1),
    (16, 3000, 40, "pad", 1), (4, 600_000, 40, "pad", 2),
    (16, 4096, 8, "retired", 1), (4, 600_000, 8, "retired", 2),
    (16, 300_000, 6, "dead", 4)])
def test_ell_relax_tree_groups_equal_plain(cuda_device, B, n, deg, kind, G):
    """Each tree-group size G (on an H100's 132 SMs: below and above
    the B * n where G changes), the padding-only rows ("pad": every
    fifth row), the fold from device memory (deg 40: TILE_V * deg passes
    the edge buffer), one tree alive ("retired") and none ("dead")."""
    assert launch_geometry(B, n, sm_count(cuda_device))[0] == G
    assert (TILE_V * deg > EDGE_SLOTS) == (deg == 40)
    state = sweep_state(np.random.default_rng(B * 7 + deg), B, n, deg,
                        cuda_device)
    if kind == "pad":
        state[5][::5] = torch.inf
    elif kind in ("retired", "dead"):
        state[2] = state[0].clone()         # dense prop: every tree relaxes
        state[3][:] = False
        state[3][B // 2] = kind == "retired"
    kd, km = ell_relax(*state)
    pd, pm = ell_sweep_plain(*state)
    assert torch.equal(kd, pd) and torch.equal(km, pm)
    if kind == "dead":
        assert torch.equal(kd, state[0]) and torch.equal(km, state[1])


@pytest.mark.parametrize("B", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("K,N", [(127, 129), (129, 257), (257, 127),
                                 (96, 256), (33, 384)])
def test_minplus_ragged_tiles_equal_plain(cuda_device, B, K, N):
    """B, K and N around the 64 x 128 output tile and the 32-deep K
    stage (N % 4 == 0 copies W as 16 B vectors, else 4 B), with few
    distinct values (ties across stages) and all-unreachable columns."""
    rng = np.random.default_rng(B * 1000 + K + N)
    dist = np.where(rng.random((B, K)) < 0.7, rng.integers(0, 4, (B, K)),
                    np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 50, (B, K)),
                     -1).astype(np.int32)
    w = np.where(rng.random((K, N)) < 0.2, rng.integers(1, 4, (K, N)),
                 np.inf).astype(np.float32)
    w[:, ::7] = np.inf
    ops = [torch.as_tensor(x, device=cuda_device) for x in (dist, mrank, w)]
    kd, km = minplus(*ops)
    pd, pm = minplus_plain(*ops)
    assert torch.equal(kd, pd) and torch.equal(km, pm)
    assert not bool(torch.isfinite(kd[:, ::7]).any())
    assert bool((km[:, ::7] == -1).all())


def query_state(rng, n, L, Q, device):
    """A label table of ``n`` rows at width ``L`` and ``Q`` query pairs:
    counts 0..L (row 0 empty, row 1 full), hubs from a pool of about L
    (rows repeat hubs), distances 0..4 (ties), every 11th row on hubs of
    its own (disjoint from all others), every 13th pair u == v, and
    every 5th u and 7th v a negative id."""
    count = rng.integers(0, L + 1, n).astype(np.int32)
    count[0], count[1] = 0, L
    slot = np.arange(L)[None, :] < count[:, None]
    h = rng.integers(0, max(3, L), (n, L))
    h[::11] += 1_000_000 + np.arange(0, n, 11)[:, None] * L
    h = np.where(slot, h, -1).astype(np.int32)
    d = np.where(slot, rng.integers(0, 5, (n, L)),
                 np.inf).astype(np.float32)
    u = rng.integers(0, n, Q)
    v = rng.integers(0, n, Q)
    v[::13] = u[::13]
    u[::5] -= n
    v[::7] -= n
    t = interop.label_table(h, d, count, device)
    return t, torch.as_tensor(u, device=device), torch.as_tensor(
        v, device=device)


def plain_in_chunks(table, u, v):
    """`labels.query_pairs` over query chunks that keep its [q, L, L]
    cube near 2^26 elements (it is per query, so chunks change
    nothing)."""
    L = table.cap
    step = max(1, 2 ** 26 // max(1, L * L))
    parts = [labels.query_pairs(table, u[i:i + step], v[i:i + step])
             for i in range(0, u.shape[0], step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


@pytest.mark.parametrize("L", [1, 3, 8, 9, 32, 33, 288, 700])
@pytest.mark.parametrize("Q", [1, 45, 1000, 65_537])
def test_label_query_table_and_operand_forms_equal_plain(cuda_device, L, Q):
    rng = np.random.default_rng(L * 100_003 + Q)
    t, u, v = query_state(rng, 3000, L, Q, cuda_device)
    pd, ph = plain_in_chunks(t, u, v)
    LABEL_QUERY.launches = 0
    kd, kh = query_table(t, u, v)
    assert LABEL_QUERY.launches == 1
    assert torch.equal(kd, pd) and torch.equal(kh, ph)
    # the operand form on the gathered rows: every slot read, count = L
    od, oh = label_query(t.hubs[u], t.dist[u], t.hubs[v], t.dist[v])
    assert torch.equal(od, pd) and torch.equal(oh, ph)
    # the state holds what it claims: disjoint pairs and u == v pairs
    ru, rv = u % t.n, v % t.n
    full = t.count[ru] > 0
    assert bool(torch.isfinite(kd[(ru == rv) & full]).all())
    if Q >= 1000:
        assert bool(torch.isinf(kd).any()) and bool(torch.isfinite(kd).any())


@pytest.mark.parametrize("L", [1100, 1101])
def test_label_query_rows_past_one_tile(cuda_device, L):
    """Rows wider than the 1,024 slots a warp stages at once: the v-row
    goes through shared memory in several tiles (16 B vectors at
    L = 1100, single slots at L = 1101)."""
    rng = np.random.default_rng(L)
    t, u, v = query_state(rng, 200, L, 300, cuda_device)
    assert int(t.count.max()) > 1024
    pd, ph = plain_in_chunks(t, u, v)
    kd, kh = query_table(t, u, v)
    assert torch.equal(kd, pd) and torch.equal(kh, ph)
    od, oh = label_query(t.hubs[u], t.dist[u], t.hubs[v], t.dist[v])
    assert torch.equal(od, pd) and torch.equal(oh, ph)


@pytest.mark.parametrize("L", [8, 32, 288])
def test_query_table_is_one_launch(cuda_device, L):
    """A ``query_table`` call on the card runs one kernel, the
    hand-written one: no gather, no fill, no copy (profiler names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(L)
    t, u, v = query_state(rng, 500, L, 4096, cuda_device)
    query_table(t, u, v)
    torch.cuda.synchronize()
    LABEL_QUERY.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        query_table(t, u, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert LABEL_QUERY.launches == 1
    assert len(names) == 1 and "label_query" in names[0], names


def test_label_query_table_refuses_wrong_operands(cuda_device):
    t = labels.empty(10, 8, cuda_device)
    ids = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int64"):
        query_table(t, ids.int(), ids)
    with pytest.raises(ValueError, match="CUDA"):
        query_table(t, ids, ids.cpu())
    with pytest.raises(ValueError, match="shape"):
        query_table(t, ids, ids[:2])
    with pytest.raises(ValueError, match="int32"):
        query_table(labels.LabelTable(t.hubs, t.dist, t.count.long()),
                    ids, ids)


def test_label_query_handles_empty_batches(cuda_device):
    t = labels.empty(10, 8, cuda_device)
    none = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    d, h = query_table(t, none, none)
    assert d.shape == (0,) and h.shape == (0,)
    ids = torch.arange(10, device=cuda_device)
    d, h = query_table(t, ids, ids)            # every row empty
    assert bool(torch.isinf(d).all()) and bool((h == -1).all())
    # rows of width 0 (the plain version has no minimum over them)
    x = torch.full((4, 0), -1, dtype=torch.int32, device=cuda_device)
    d, h = label_query(x, x.float(), x, x.float())
    assert bool(torch.isinf(d).all()) and bool((h == -1).all())


def test_out_of_range_id_is_a_device_fault(cuda_device):
    """An id outside [-n, n) stops the kernel with a device-side assert,
    as tensor indexing does, instead of reading a stray row. It runs in
    a child process: the fault ends that process's CUDA context."""
    root = Path(__file__).resolve().parents[1]
    code = (
        "import torch\n"
        "from repro_torch.core import labels\n"
        "from repro_torch.kernels.label_query import query_table\n"
        "t = labels.empty(10, 8, 'cuda')\n"
        "u = torch.tensor([3, 10], device='cuda')\n"
        "query_table(t, u, u)\n"
        "torch.cuda.synchronize()\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode != 0
    assert "assert" in (res.stdout + res.stderr).lower()


@pytest.mark.parametrize("algo,windows", [("plant", False), ("gll", False),
                                          ("plant", True)])
def test_resume_on_card_equals_cpu(cuda_device, algo, windows, tmp_path,
                                   monkeypatch):
    """A card build crashed at its third ``engine.commit`` resumes on the
    card to the CPU build's table, counters and records; so does a
    card resume from the CPU's checkpoints of the same build (with
    ``windows`` an L2 that forces 3 source windows on the card)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.engine import run_build
    from repro_torch.ft import Fault, FaultPlan, InjectedCrash, faults
    g = random_connected(300, 260, seed=7, max_w=3)
    rank = degree_ranking(g)
    kw = dict(algo=algo, batch=8, alpha=2.0)
    cpu = run_build(g, rank, device="cpu", **kw)
    if windows:
        monkeypatch.setattr(port_layout, "l2_bytes",
                            lambda device: 2 * 8 * 8 * 128)
    mgr = CheckpointManager(str(tmp_path / "card"), keep=100)
    with faults(FaultPlan({"engine.commit": [Fault("crash", after=2)]})):
        with pytest.raises(InjectedCrash):
            run_build(g, rank, device=cuda_device, ckpt=mgr, **kw)
    for k in (ELL_RELAX, WINDOWED_KERNEL):
        k.launches = 0
    card = run_build(g, rank, device=cuda_device, ckpt=mgr, resume=True,
                     **kw)
    assert card.resumed_from is not None and card.resumed_from > 0
    assert (WINDOWED_KERNEL if windows else ELL_RELAX).launches > 0
    cpu_mgr = CheckpointManager(str(tmp_path / "cpu"), keep=100)
    run_build(g, rank, device="cpu", ckpt=cpu_mgr, **kw)
    for s in cpu_mgr.all_steps()[1:]:
        __import__("shutil").rmtree(cpu_mgr._step_dir(s))
    from_cpu = run_build(g, rank, device=cuda_device, ckpt=cpu_mgr,
                         resume=True, **kw)
    assert from_cpu.resumed_from == cpu_mgr.all_steps()[0]
    for res in (card, from_cpu):
        assert res.sink.table().hubs.device.type == "cuda"
        for a, b in zip(res.sink.table(), cpu.sink.table()):
            assert torch.equal(a.cpu(), b)
        assert res.counters == cpu.counters
    assert [r.trees for r in card.records] == [r.trees for r in cpu.records]


def test_repair_on_card_equals_cpu(cuda_device):
    """``apply`` on a card index (the frontier's endpoint sweeps and the
    re-plant on the card) equals the CPU repair, array for array, and
    the service handed out before the mutation answers the mutated
    graph's distances through the query kernel."""
    from repro_torch.dynamic import random_mutations
    from repro_torch.sssp.oracle import dijkstra
    g = grid_road(9, 9, seed=1)
    rank = degree_ranking(g)
    batch = random_mutations(g, np.random.default_rng(5), inserts=1,
                             deletes=1, reweights=1)
    cpu = build(g, rank, BuildPlan(algo="plant", batch=8), device="cpu")
    cpu_rep = cpu.apply(batch, graph=g)
    card = build(g, rank, BuildPlan(algo="plant", batch=8),
                 device=cuda_device)
    svc = card.serve(batch_size=64, cache=256)
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, g.n, 200), rng.integers(0, g.n, 200)
    svc.submit(u, v)
    svc.flush()
    for k in (ELL_RELAX, LABEL_QUERY):
        k.launches = 0
    rep = card.apply(batch, graph=g)
    assert ELL_RELAX.launches > 0
    assert card.store.device.type == "cuda"
    for a, b in zip(card.table, cpu.table):
        assert torch.equal(a.cpu(), b)
    # the card's sweep loop checks its fixpoint every 4 sweeps, the
    # CPU's every sweep: only the records' sweep counts differ
    p, c = rep.to_dict(), cpu_rep.to_dict()
    for r in (p, c):
        r.pop("wall_s")
        r["supersteps"] = [(s["labels"], s["explored"], s["trees"])
                           for s in r["supersteps"]]
    assert p == c and rep.affected > 0
    svc.submit(u, v)
    got = svc.flush()
    assert svc.stats_.invalidations == 1 and LABEL_QUERY.launches > 0
    g_new = batch.apply(g)
    want = np.array([dijkstra(g_new, int(a))[int(b)] for a, b in zip(u, v)],
                    np.float32)
    assert np.array_equal(got, want)


# ------------------------------------- directed and hub-sharded paths

@pytest.mark.parametrize("L", [1, 8, 33, 288])
@pytest.mark.parametrize("Q", [1, 1000, 65_537])
def test_label_query_pair_rows_equals_plain(cuda_device, L, Q):
    """The two-table form (u's row from one table, v's from another):
    one launch, equal to the plain version over the gathered rows, with
    empty rows, ties, disjoint rows and negative ids."""
    from repro_torch.kernels.label_query import (label_query_pair_rows,
                                                 label_query_ref)
    rng = np.random.default_rng(L * 7 + Q)
    t_out, u, v = query_state(rng, 3000, L, Q, cuda_device)
    t_in, _, _ = query_state(rng, 3000, L, 1, cuda_device)
    before = LABEL_QUERY.launches
    kd, kh = label_query_pair_rows(t_out, t_in, u, v)
    assert LABEL_QUERY.launches == before + 1
    step = max(1, 2 ** 26 // (L * L))
    parts = [label_query_ref(t_out.hubs[u[i:i + step]],
                             t_out.dist[u[i:i + step]],
                             t_in.hubs[v[i:i + step]],
                             t_in.dist[v[i:i + step]])
             for i in range(0, Q, step)]
    pd = torch.cat([p[0] for p in parts])
    ph = torch.cat([p[1] for p in parts])
    assert torch.equal(kd, pd) and torch.equal(kh, ph)


def test_label_query_pair_rows_refuses_unequal_tables(cuda_device):
    from repro_torch.kernels.label_query import label_query_pair_rows
    a = labels.empty(10, 4, cuda_device)
    b = labels.empty(10, 8, cuda_device)
    ids = torch.zeros(3, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="differ in shape"):
        label_query_pair_rows(a, b, ids, ids)
    with pytest.raises(ValueError, match="int64"):
        label_query_pair_rows(a, a, ids.int(), ids)


def test_sharded_stacked_query_equals_dense_with_a_tie(cuda_device):
    """The stacked query (K launches and one cross-shard minimum) equals
    the dense query on the card, and a tie across shards takes the
    lowest shard's hub."""
    from repro_torch.index.store import ShardedStore
    g = random_connected(300, 400, seed=2, max_w=3)
    rank = degree_ranking(g)
    dense = build(g, rank, BuildPlan(algo="plant", batch=8),
                  device=cuda_device)
    st = ShardedStore.from_table(dense.table, rank, 4)
    rng = np.random.default_rng(1)
    u, v = rng.integers(0, g.n, 5000), rng.integers(0, g.n, 5000)
    before = LABEL_QUERY.launches
    d, _ = st.query(u, v)
    assert LABEL_QUERY.launches == before + 4
    assert np.array_equal(d, dense.query(u, v))
    h = np.full((3, 2, 1), -1, np.int32)
    dd = np.full((3, 2, 1), np.inf, np.float32)
    c = np.zeros((3, 2), np.int32)
    for k, hub in ((1, 5), (2, 6)):        # both shards answer 3 for (0, 1)
        h[k, :, 0], dd[k, 0, 0], dd[k, 1, 0], c[k] = hub, 1.0, 2.0, 1
    tie = ShardedStore(*(torch.as_tensor(x, device=cuda_device)
                         for x in (h, dd, c)))
    td, th = tie.query([0, 1], [1, 0])
    assert td.tolist() == [3.0, 3.0] and th.tolist() == [5, 5]


@pytest.mark.parametrize("what", ["directed", "sharded-plant",
                                  "sharded-gll"])
def test_directed_and_sharded_builds_on_card_equal_cpu(cuda_device, what):
    if what == "directed":
        g = random_connected(80, 160, seed=4, directed=True)
        plan = BuildPlan(algo="directed", batch=8)
    else:
        g = grid_road(9, 9, seed=1)
        plan = BuildPlan(algo=what.split("-")[1], batch=8, store="sharded",
                         shards=3)
    rank = degree_ranking(g)
    LABEL_QUERY.launches = 0
    card = build(g, rank, plan, device=cuda_device)
    cpu = build(g, rank, plan, device="cpu")
    if what == "directed":
        for a, b in zip(list(card.l_out) + list(card.l_in),
                        list(cpu.l_out) + list(cpu.l_in)):
            assert torch.equal(a.cpu(), b)
    else:
        for (_, a), (_, b) in zip(card.store.shard_arrays(),
                                  cpu.store.shard_arrays()):
            for key in ("hubs", "dist", "count"):
                assert np.array_equal(a[key], b[key])
    rng = np.random.default_rng(0)
    u, v = rng.integers(0, g.n, 500), rng.integers(0, g.n, 500)
    cd, ch = card.query_with_hub(u, v)
    pd, ph = cpu.query_with_hub(u, v)
    assert np.array_equal(cd, pd) and np.array_equal(ch, ph)
    svc = card.serve(mode="qlsn", batch_size=128)
    svc.submit(u, v)
    assert np.array_equal(svc.flush(), pd)
    # one launch a directed query; K a stacked one, at most K routed
    assert LABEL_QUERY.launches > 0


@pytest.mark.parametrize("codec,exact", [("bf16", False), ("u16", True),
                                         ("u16", False), ("u32", True),
                                         ("u32", False)])
@pytest.mark.parametrize("shards", [1, 3])
def test_compressed_store_on_card_equals_cpu(cuda_device, codec, exact,
                                             shards):
    """The same encoded shards on the card and on the CPU answer equal
    (dist, hub), stacked and routed; a card build encodes the same
    shards as the CPU build."""
    from repro_torch.index.store import CompressedStore
    from repro_torch.serve import RoutedAnswer
    g = grid_road(12, 12, seed=3)
    rank = degree_ranking(g)
    plan = BuildPlan(algo="plant", batch=8, store="compressed", codec=codec,
                     quant_exact=exact, shards=shards)
    cpu = build(g, rank, plan, device="cpu")
    card = build(g, rank, plan, device=cuda_device)
    assert isinstance(card.store, CompressedStore)
    assert card.store.device.type == "cuda"
    for (_, a), (_, b) in zip(card.store.shard_arrays(),
                              cpu.store.shard_arrays()):
        for key in ("dhub", "dcode", "count"):
            assert a[key].dtype == b[key].dtype
            assert np.array_equal(a[key], b[key])
    assert card.store.dtypes() == cpu.store.dtypes()
    rng = np.random.default_rng(2)
    u, v = rng.integers(0, g.n, 3000), rng.integers(0, g.n, 3000)
    before = LABEL_QUERY.launches
    cd, ch = card.query_with_hub(u, v)
    assert LABEL_QUERY.launches == before + shards
    pd, ph = cpu.query_with_hub(u, v)
    assert np.array_equal(cd, pd) and np.array_equal(ch, ph)
    if shards > 1:
        routed = RoutedAnswer(card.store)(u, v)
        assert np.array_equal(routed.cpu().numpy(), pd)


@pytest.mark.parametrize("shards", [1, 2])
def test_spill_store_on_card_equals_cpu(cuda_device, shards, tmp_path):
    """A spill store intersecting on the card (host gather, copy, one
    operand-form launch a shard) equals the CPU spill store and the
    dense store."""
    from repro_torch.index import CHLIndex
    g = random_connected(300, 400, seed=2, max_w=3)      # tie-heavy
    rank = degree_ranking(g)
    idx = build(g, rank, BuildPlan(algo="plant", batch=8, store="sharded",
                                   shards=shards), device="cpu")
    path = idx.save(str(tmp_path / "idx"))
    card = CHLIndex.load(path, store="spill", device=cuda_device)
    cpu = CHLIndex.load(path, store="spill", device="cpu")
    assert card.store.is_mapped()
    rng = np.random.default_rng(5)
    u, v = rng.integers(0, g.n, 4000), rng.integers(0, g.n, 4000)
    before = LABEL_QUERY.launches
    cd, ch = card.query_with_hub(u, v)
    assert LABEL_QUERY.launches == before + shards
    pd, ph = cpu.query_with_hub(u, v)
    assert np.array_equal(cd, pd) and np.array_equal(ch, ph)
    assert np.array_equal(cd, idx.query(u, v))
    svc = card.serve(mode="qlsn", batch_size=512)
    svc.submit(u, v)
    assert np.array_equal(svc.flush(), pd)


def test_code_gathers_and_decoders_on_card_equal_numpy(cuda_device):
    """Storage codes held on the card (u8 as uint8, u16/u32 as the
    int16/int32 tensor of their bits) gather and decode equal to numpy,
    u32 codes past 2^24 rounded to nearest even."""
    from repro_torch.index import quant
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 500, 2000)
    ids_d = torch.as_tensor(ids, device=cuda_device)
    for dt in (np.uint8, np.uint16, np.uint32):
        a = rng.integers(0, np.iinfo(dt).max, (500, 7),
                         dtype=np.uint64).astype(dt)
        a[::7, 3] = np.iinfo(dt).max
        t = quant.code_tensor(a, cuda_device)
        got = quant.code_array(t[ids_d], dt)
        assert got.dtype == a.dtype and np.array_equal(got, a[ids])
        for codec in {np.uint16: ("bf16", "u16"), np.uint32: ("u32",)}.get(
                dt, ()):
            for scale in (1.0, float(np.float32(6.86e6 / 0xFFFFFFFE))):
                want = quant.decode_dist_np(a[ids], codec, scale)
                dec = quant.decode_dist_torch(t[ids_d], codec, scale)
                assert np.array_equal(dec.cpu().numpy().view(np.int32),
                                      want.view(np.int32))
    rank, n = rng.permutation(300), 300
    order, oi = quant.order_permutation(rank)
    hubs = rng.integers(0, n, (n, 5)).astype(np.int32)
    count = rng.integers(0, 6, n).astype(np.int32)
    hubs[np.arange(5)[None, :] >= count[:, None]] = -1
    deltas, _, cnt = quant.delta_encode_rows(
        hubs, np.ones((n, 5), np.float32), count, oi)
    dev = quant.delta_decode_rows_torch(
        quant.code_tensor(deltas, cuda_device)[ids_d[ids_d < n]],
        torch.as_tensor(cnt, device=cuda_device)[ids_d[ids_d < n]],
        torch.as_tensor(order, device=cuda_device))
    want = quant.delta_decode_rows_np(deltas, cnt, order)[ids[ids < n]]
    assert np.array_equal(dev.cpu().numpy(), want)


DIST_PLANS = {
    "hybrid": BuildPlan(algo="hybrid", batch=4, eta=4, psi_th=2.0),
    "hybrid-compact": BuildPlan(algo="hybrid", batch=4, eta=4, psi_th=2.0,
                                compact=16),
    "dgll": BuildPlan(algo="dgll", batch=4, beta=4.0),
    "plant-dist": BuildPlan(algo="plant-dist", batch=4),
}


@pytest.mark.parametrize("windows", [False, True])
@pytest.mark.parametrize("what", sorted(DIST_PLANS))
def test_distributed_builds_on_card_equal_cpu(cuda_device, what, windows,
                                              monkeypatch):
    """An 8-node logical mesh on the card gives the CPU mesh's per-node
    partitions, merged table and records (the node steps' sweeps on the
    dense kernel, or with ``windows`` an L2 that forces 3 source
    windows, on the windowed one); a PLaNT superstep calls no
    collective and a DGLL superstep at least one."""
    from repro_torch.core.dgll import stack_partitions
    from repro_torch.parallel import NodeMesh
    from repro_torch.parallel import collectives as coll
    g = scale_free(300, attach=2, seed=3)
    rank = degree_ranking(g)
    plan = DIST_PLANS[what]
    cpu = build(g, rank, plan, mesh=NodeMesh.logical(8, "cpu"))
    if windows:
        monkeypatch.setattr(port_layout, "l2_bytes",
                            lambda device: 2 * 8 * 4 * 128)
    for k in (ELL_RELAX, WINDOWED_KERNEL):
        k.launches = 0
    coll.reset_counts()
    card = build(g, rank, plan, mesh=NodeMesh.logical(8, cuda_device))
    calls = coll.total_calls()
    assert (WINDOWED_KERNEL if windows else ELL_RELAX).launches > 0
    assert (ELL_RELAX if windows else WINDOWED_KERNEL).launches == 0
    modes = {r.mode for r in card.report.supersteps}
    if modes <= {"plant", "plant-hc"}:
        assert calls == 0
    else:
        assert calls > 0
    for a, b in zip(stack_partitions(card.partitioned),
                    stack_partitions(cpu.partitioned)):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    for a, b in zip(card.table, cpu.table):
        assert torch.equal(a.cpu(), b)
    assert card.report.supersteps == cpu.report.supersteps
    assert card.report.comm_label_slots == cpu.report.comm_label_slots


@pytest.mark.parametrize("q", [1, 3, 8])
def test_query_modes_on_card_equal_qlsn(cuda_device, q):
    """qfdl (one table-form launch a node, then ``pmin``) and qdol (one
    operand-form launch a node over its gathered rows) on a q-node
    logical mesh on the card equal qlsn and the CPU's answers."""
    from repro_torch.parallel import NodeMesh
    g = grid_road(9, 11, seed=2)
    rank = degree_ranking(g)
    plan = BuildPlan(algo="hybrid", batch=4, eta=4, psi_th=2.0)
    card = build(g, rank, plan, mesh=NodeMesh.logical(q, cuda_device))
    cpu = build(g, rank, plan, mesh=NodeMesh.logical(q, "cpu"))
    rng = np.random.default_rng(q)
    u, v = rng.integers(0, g.n, 700), rng.integers(0, g.n, 700)
    want = cpu.query(u, v)
    assert np.array_equal(card.query(u, v), want)
    for mode in ("qfdl", "qdol"):
        LABEL_QUERY.launches = 0
        svc = card.serve(mode=mode, mesh=NodeMesh.logical(q, cuda_device),
                         batch_size=700)
        svc.submit(u, v)
        assert np.array_equal(svc.flush(), want), mode
        assert LABEL_QUERY.launches == q        # one launch a node
        svc = cpu.serve(mode=mode, mesh=NodeMesh.logical(q, "cpu"),
                        batch_size=256)
        svc.submit(u, v)
        assert np.array_equal(svc.flush(), want), mode
