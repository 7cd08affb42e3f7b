"""The port's relaxation sweep and driver against the reference package.

Exact comparisons throughout: weights are integral f32, so (min, +,
max) arithmetic is exact and every array must be bit-identical.

1. sweep — the port's plain ``ell_sweep_ref`` against the reference's
   jnp oracle, and the port's ``ell_sweep`` (CPU: the plain version
   with per-tree retirement) against the reference's Pallas kernel in
   interpret mode, over inf-padded rows, rank ties, unreachable
   vertices and retired trees;
2. driver — ``batched_sssp_maxrank`` against the reference driver's
   jnp path (the one its CPU dispatch picks): dist, mrank, sweeps and
   explored, with rank-block pruning, ``check_every`` in {1, 4} and
   frontier gating on and off;
3. source windows — the window plan, the bucketed layout's arrays, the
   bucketed plain sweep, the windowed fixpoint and a whole PLaNT build
   with forced windows, each against the reference (its windowed Pallas
   kernel in interpret mode where it has one).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as rg
import repro.kernels.ell_relax as ref_ell
from repro.graphs.ranking import degree_ranking, random_ranking
from repro.kernels.ell_relax import ell_sweep as ref_ell_sweep
from repro.kernels.ell_relax import ell_sweep_ref as ref_sweep_ref
from repro.sssp import relax as ref_relax
from repro_torch import interop
from repro_torch.kernels import all_kernels
from repro_torch.kernels.ell_relax import (
    KERNEL, WINDOWED_KERNEL, build_bucketed_ell, ell_relax,
    ell_relax_windowed, ell_sweep, ell_sweep_bucketed_plain,
    ell_sweep_plain, ell_sweep_ref, kernel_fits, layout_plan,
    resolve_sweep_backend, sweep_layout, window_cap, window_plan)
from repro_torch.kernels.ell_relax import layout as port_layout
from repro_torch.kernels.ell_relax import ref as port_ref
from repro_torch.sssp import relax

torch.set_num_threads(1)


def sweep_state(rng, B, n, deg, consistent_alive=True):
    dist = np.where(rng.random((B, n)) < 0.5,
                    rng.integers(0, 9, (B, n)), np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 99, (B, n)),
                     -1).astype(np.int32)
    blocked = rng.random((B, n)) < 0.2
    frontier = rng.random((B, n)) < 0.7
    dead = rng.random(B) < 0.3
    frontier[dead] = False                 # retired trees: empty frontier
    prop = np.where(blocked | ~frontier, np.inf, dist).astype(np.float32)
    alive = frontier.any(axis=1) if consistent_alive else ~dead
    ell_src = rng.integers(0, n, (n, deg)).astype(np.int32)
    ell_w = np.where(rng.random((n, deg)) < 0.4,
                     rng.integers(1, 9, (n, deg)),
                     np.inf).astype(np.float32)
    rank = rng.permutation(n).astype(np.int32)
    return dist, mrank, prop, alive, ell_src, ell_w, rank


def as_torch(xs):
    return [torch.as_tensor(x) for x in xs]


@pytest.mark.parametrize("B,n,deg", [(1, 1, 1), (3, 5, 7), (8, 64, 8),
                                     (5, 130, 17), (2, 40, 40)])
def test_ref_equals_reference_oracle(B, n, deg):
    rng = np.random.default_rng(B * 100 + n)
    dist, mrank, prop, _, es, ew, rank = sweep_state(rng, B, n, deg)
    pd, pm = ell_sweep_ref(*as_torch((dist, mrank, prop, mrank, es, ew,
                                      rank)))
    rd, rm = ref_sweep_ref(*(jnp.asarray(x) for x in
                             (dist, mrank, prop, mrank, es, ew, rank)))
    assert np.array_equal(pd.numpy(), np.asarray(rd))
    assert np.array_equal(pm.numpy(), np.asarray(rm))


@pytest.mark.parametrize("B,n,deg", [(3, 5, 7), (9, 130, 17), (4, 64, 3)])
def test_sweep_equals_interpret_kernel(B, n, deg):
    """`ell_sweep` on CPU tensors == the reference's Pallas kernel in
    interpret mode (retired trees included), and launches nothing."""
    rng = np.random.default_rng(7 + n)
    state = sweep_state(rng, B, n, deg)
    before = KERNEL.launches
    pd, pm = ell_sweep(*as_torch(state))
    kd, km = ref_ell_sweep(*(jnp.asarray(x) for x in state),
                           use_kernel=True, interpret=True)
    assert np.array_equal(pd.numpy(), np.asarray(kd))
    assert np.array_equal(pm.numpy(), np.asarray(km))
    assert KERNEL.launches == before


def test_retired_trees_pass_through():
    """alive == False copies a tree through even when its prop plane is
    not masked — the kernel's per-tree retirement."""
    rng = np.random.default_rng(3)
    state = list(sweep_state(rng, 6, 50, 8, consistent_alive=False))
    state[2] = state[0].copy()             # dense prop: every tree relaxes
    alive = np.array([True, False, True, False, False, True])
    state[3] = alive
    d, m = ell_sweep_plain(*as_torch(state))
    rd, rm = ref_sweep_ref(*(jnp.asarray(x) for x in
                             (state[0], state[1], state[2], state[1],
                              state[4], state[5], state[6])))
    assert np.array_equal(d.numpy()[alive], np.asarray(rd)[alive])
    assert np.array_equal(m.numpy()[alive], np.asarray(rm)[alive])
    assert np.array_equal(d.numpy()[~alive], state[0][~alive])
    assert np.array_equal(m.numpy()[~alive], state[1][~alive])


def test_kernel_wrapper_refuses_cpu_tensors():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="CUDA"):
        ell_relax(*as_torch(sweep_state(rng, 2, 9, 3)))


def _graph(kind):
    if kind == "grid":
        g = rg.grid_road(6, 6, seed=2)
        return g, degree_ranking(g)
    g = rg.random_connected(40, 30, seed=4, max_w=3)    # tie-heavy
    return g, random_ranking(g.n, seed=1)


@pytest.mark.parametrize("kind,check_every,gating,blocked", [
    ("ties", 1, False, False), ("ties", 4, True, False),
    ("ties", 1, True, True), ("ties", 4, False, True),
    ("ties", 4, True, True), ("grid", 1, False, False),
    ("grid", 4, True, True),
])
def test_driver_matches_reference(kind, check_every, gating, blocked):
    g, rank = _graph(kind)
    roots = np.array([0, 5, g.n - 1, 7, 3], np.int32)
    pr = torch.as_tensor(rank)
    pst = relax.batched_sssp_maxrank(
        torch.as_tensor(g.ell_src), torch.as_tensor(g.ell_w), pr,
        torch.as_tensor(roots), check_every=check_every,
        frontier_gating=gating,
        block_fn=relax.rank_block(pr) if blocked else None)
    jr = jnp.asarray(rank)
    rst = ref_relax.batched_sssp_maxrank(
        jnp.asarray(g.ell_src), jnp.asarray(g.ell_w), jr,
        jnp.asarray(roots), check_every=check_every,
        frontier_gating=gating, use_kernel=False,
        block_fn=ref_relax.rank_block(jr) if blocked else None)
    assert np.array_equal(pst.dist.numpy(), np.asarray(rst.dist))
    assert np.array_equal(pst.mrank.numpy(), np.asarray(rst.mrank))
    assert pst.sweeps == int(rst.sweeps)
    assert np.array_equal(pst.explored.numpy(), np.asarray(rst.explored))


def test_cpu_defaults_follow_reference_dispatch():
    """No knobs: the port's CPU path is ungated with stride 1, exactly
    what the reference's auto dispatch runs on CPU — same sweep count."""
    g, rank = _graph("grid")
    roots = np.arange(4, dtype=np.int32)
    pst = relax.batched_sssp_maxrank(
        torch.as_tensor(g.ell_src), torch.as_tensor(g.ell_w),
        torch.as_tensor(rank), torch.as_tensor(roots))
    rst = ref_relax.batched_sssp_maxrank(
        jnp.asarray(g.ell_src), jnp.asarray(g.ell_w), jnp.asarray(rank),
        jnp.asarray(roots))
    assert pst.sweeps == int(rst.sweeps)
    assert np.array_equal(pst.mrank.numpy(), np.asarray(rst.mrank))


def test_batched_sssp_and_combined_blocks():
    g, rank = _graph("ties")
    roots = np.array([1, 2, 3], np.int32)
    d = relax.batched_sssp(torch.as_tensor(g.ell_src),
                           torch.as_tensor(g.ell_w), torch.as_tensor(roots))
    rd = ref_relax.batched_sssp(jnp.asarray(g.ell_src),
                                jnp.asarray(g.ell_w), jnp.asarray(roots))
    assert np.array_equal(d.numpy(), np.asarray(rd))
    pr, jr = torch.as_tensor(rank), jnp.asarray(rank)
    never = lambda dist, roots: torch.zeros_like(dist, dtype=torch.bool)
    blk = relax.combine_blocks(relax.rank_block(pr), never)
    st = relax.batched_sssp_maxrank(
        torch.as_tensor(g.ell_src), torch.as_tensor(g.ell_w), pr,
        torch.as_tensor(roots), block_fn=blk)
    rst = ref_relax.batched_sssp_maxrank(
        jnp.asarray(g.ell_src), jnp.asarray(g.ell_w), jr,
        jnp.asarray(roots), block_fn=ref_relax.rank_block(jr))
    assert np.array_equal(st.dist.numpy(), np.asarray(rst.dist))
    assert np.array_equal(st.mrank.numpy(), np.asarray(rst.mrank))



# ------------------------------------------------------- source windows

#: ``L2_cache_size`` that torch reports for an H100 (50 MiB)
H100_L2 = 50 * 1024 * 1024


def force_window(monkeypatch, window: int, batch: int) -> None:
    """Stand in an L2 whose half holds ``window`` vertices of ``batch``
    trees' source planes, on every device (the CPU included) — the
    counterpart of the reference tests' ``REPRO_ELL_VMEM_BUDGET``."""
    monkeypatch.setattr(port_layout, "l2_bytes",
                        lambda device: 2 * 8 * batch * window)


def test_window_cap_from_l2_and_plan_geometry(monkeypatch):
    """Half the L2 over 8 B per vertex and tree sets the cap; past it
    the plan balances windows exactly as the reference's does."""
    assert window_cap(H100_L2, bb=4) == 819200
    cap = window_cap(H100_L2, bb=4)
    assert kernel_fits(819200, bb=4, max_window=cap)
    assert not kernel_fits(819201, bb=4, max_window=cap)
    # the two graphs of the card run: road and random
    assert window_plan(16_777_216, bb=4, max_window=cap) == (
        798976, 21, 16778496)
    assert window_plan(4_194_304, bb=4, max_window=cap) == (
        699136, 6, 4194816)
    assert window_plan(1000, max_window=384) == (384, 3, 1152)
    assert window_plan(1000, max_window=300).window <= 256
    assert window_plan(100, max_window=cap) == (128, 1, 128)
    for n, mw in ((131073, 131072), (1000, 384), (1000, 300), (255, 128),
                  (257, 128), (513, 128), (100, 1 << 20), (1, 128)):
        assert tuple(window_plan(n, max_window=mw)) == tuple(
            ref_ell.window_plan(n, max_window=mw)), (n, mw)
    # the CPU has no L2 to size against: no plan unless forced
    assert layout_plan(300, "cpu", bb=8) is None
    with pytest.raises(ValueError, match="L2"):
        window_plan(300, bb=8, device="cpu")
    force_window(monkeypatch, 128, 8)
    assert layout_plan(300, "cpu", bb=8).num_windows == 3
    assert layout_plan(300, "cpu", bb=2).num_windows == 1


def _rand_ell(rng, n, deg, dens=0.6):
    es = rng.integers(0, n, (n, deg)).astype(np.int32)
    ew = np.where(rng.random((n, deg)) < dens, rng.integers(1, 9, (n, deg)),
                  np.inf).astype(np.float32)
    return es, ew


@pytest.mark.parametrize("n,deg,mw", [(255, 7, 128), (257, 9, 128),
                                      (300, 5, 100), (513, 40, 200)])
def test_bucketed_arrays_equal_reference(n, deg, mw):
    es, ew = _rand_ell(np.random.default_rng(n), n, deg)
    plan = window_plan(n, max_window=mw)
    assert plan.num_windows > 1
    got = build_bucketed_ell(torch.as_tensor(es), torch.as_tensor(ew),
                             plan)
    want = ref_ell.build_bucketed_ell(es, ew, ref_ell.window_plan(
        n, max_window=mw))
    for name in ("src", "w", "chunk_win"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert (got.dk, got.num_chunks, got.plan()) == (
        want.dk, want.num_chunks, want.plan())


def test_bucketed_layout_conserves_edges():
    """Both the reference-format buckets and the kernel's window-major
    segments hold each row's finite in-edge multiset exactly."""
    n = 700
    es, ew = _rand_ell(np.random.default_rng(7), n, 9, dens=0.4)
    ew[5] = np.inf                                  # a row with no edge
    lay = sweep_layout(torch.as_tensor(es), torch.as_tensor(ew), bb=1,
                       max_window=256)
    assert lay is not None and lay.num_windows == 3
    src_b, w_b = lay.src.numpy(), lay.w.numpy()
    cw = lay.chunk_win.numpy()
    assert cw.shape == (lay.n_pad // lay.bn, lay.num_chunks)
    assert ((cw >= 0) & (cw < lay.num_windows)).all()
    fin = np.isfinite(w_b)
    assert ((src_b >= 0) & (src_b < lay.window))[fin].all()
    gsrc = src_b + np.repeat(np.repeat(cw, lay.bn, 0), lay.dk, 1) \
        * lay.window
    s = lay.segments
    row, ptr = s.seg_row.numpy(), s.seg_ptr.numpy()
    flags = s.seg_flags.numpy()
    esrc, ewt = s.edge_src.numpy(), s.edge_w.numpy()
    by_row = {}
    for i in range(len(row)):
        by_row.setdefault(int(row[i]), []).append(i)
    for wd in range(lay.num_windows):            # destinations ascend
        seg = row[s.win_segs[wd]:s.win_segs[wd + 1]]
        assert (np.diff(seg) > 0).all()
        lo, hi = ptr[s.win_segs[wd]], ptr[s.win_segs[wd + 1]]
        assert (esrc[lo:hi] // lay.window == wd).all()
    for v in range(n):
        orig = sorted((int(a), float(b)) for a, b in zip(es[v], ew[v])
                      if np.isfinite(b))
        got = sorted((int(a), float(b)) for a, b in
                     zip(gsrc[v][fin[v]], w_b[v][fin[v]]))
        segs = by_row.get(v, [])
        kern = sorted((int(esrc[e]), float(ewt[e])) for i in segs
                      for e in range(ptr[i], ptr[i + 1]))
        assert got == orig == kern, v
        if segs:
            assert [flags[i] & 1 for i in segs] == [1] + [0] * (len(segs)
                                                                - 1)
            assert [flags[i] >> 1 for i in segs] == [0] * (len(segs) - 1) \
                + [1]
    bare = np.flatnonzero(~np.isfinite(ew).any(axis=1))
    assert 5 in bare and s.bare_rows.tolist() == bare.tolist()
    assert not fin[n:].any()


def _tiled_ell(kind):
    """(ell_src, ell_w, max_window) for the tile tests: a random graph,
    one with a hub row whose in-edges in one window pass the edge
    limit, one whose middle window holds no source, one with no finite
    edge at all."""
    rng = np.random.default_rng(len(kind))
    if kind == "random":
        es, ew = _rand_ell(rng, 1500, 9)
        return es, ew, 256
    if kind == "dense":                  # many edges per segment
        es, ew = _rand_ell(rng, 600, 200, dens=0.9)
        return es, ew, 256
    if kind == "hub":
        n = 2 * port_layout.TILE_EDGES + 512
        es, ew = _rand_ell(rng, n, n // 2, dens=0.01)
        es[7] = np.arange(n // 2)               # all in the first window
        ew[7] = rng.integers(1, 9, n // 2)
        return es, ew, n // 2
    if kind == "gap":
        es, ew = _rand_ell(rng, 1000, 5)
        es = np.where((es >= 256) & (es < 512), es - 256, es)
        return es.astype(np.int32), ew, 256
    es, ew = _rand_ell(rng, 300, 4)
    return es, np.full_like(ew, np.inf), 128


@pytest.mark.parametrize("kind", ["random", "dense", "hub", "gap",
                                  "edgeless"])
def test_tiles_cover_segments_within_limits(kind):
    """The kernel's tiles, recomputed from ``seg_ptr`` with numpy: every
    segment lies in exactly one tile, a tile lies in one window, no
    tile passes `TILE_SEGS` or `TILE_EDGES` but a lone longer segment,
    each tile is as long as the limits allow (the greedy cut), and the
    tile-relative ends rebuild ``seg_ptr``."""
    es, ew, mw = _tiled_ell(kind)
    lay = sweep_layout(torch.as_tensor(es), torch.as_tensor(ew), bb=4,
                       max_window=mw)
    s = lay.segments
    ptr = s.seg_ptr.numpy()
    S = len(ptr) - 1
    ts = s.tile_segs.numpy()
    ends = s.seg_end.numpy()
    assert np.array_equal(s.tile_edges.numpy(), ptr[ts])
    TS, TE = port_layout.TILE_SEGS, port_layout.TILE_EDGES
    assert s.seg_end.dtype == torch.int32 and ends.shape == (S,)
    assert ts[0] == 0 and ts[-1] == S and (np.diff(ts) > 0).all()
    assert len(s.win_tiles) == lay.num_windows + 1
    assert [ts[t] for t in s.win_tiles] == list(s.win_segs)
    win_end = {int(ts[t]) for t in s.win_tiles}
    for a, b in zip(ts[:-1], ts[1:]):
        ns, ne = b - a, ptr[b] - ptr[a]
        assert (ns <= TS and ne <= TE) or ns == 1
        if b not in win_end:            # the next segment did not fit
            assert ns == TS or ptr[b + 1] - ptr[a] > TE
        assert np.array_equal(ptr[a] + ends[a:b], ptr[a + 1:b + 1])
    lone = [(a, b) for a, b in zip(ts[:-1], ts[1:]) if ptr[b] - ptr[a] > TE]
    assert bool(lone) == (kind == "hub")
    if kind == "gap":
        assert s.win_tiles[1] == s.win_tiles[2]     # window 1 is empty
    if kind == "edgeless":
        assert S == 0 and s.win_tiles == [0] * (lay.num_windows + 1)


def test_tiles_refuse_offsets_past_i32():
    """A tile whose edges pass the i32 range raises, so no offset
    wraps in the kernel."""
    ptr = torch.tensor([0, 2 ** 31 + 5], dtype=torch.int64)
    with pytest.raises(ValueError, match="i32"):
        port_layout._tiles(ptr, torch.zeros(1, dtype=torch.int64), [0, 1])
    end, tiles, edges, win = port_layout._tiles(
        torch.tensor([0, 2 ** 31 - 1], dtype=torch.int64),
        torch.zeros(1, dtype=torch.int64), [0, 1])
    assert end.tolist() == [2 ** 31 - 1] and tiles.tolist() == [0, 1]
    assert edges.tolist() == [0, 2 ** 31 - 1] and win == [0, 1]


def test_tile_limits_match_kernel_source():
    """The layout cuts tiles to the buffers the kernel declares."""
    import re
    from pathlib import Path
    src = (Path(port_layout.__file__).parent / "csrc"
           / "ell_relax_windowed.cu").read_text()
    for name in ("TILE_SEGS", "TILE_EDGES"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(port_layout, name), name


@pytest.mark.parametrize("n", [255, 256, 257, 300, 513])
def test_bucketed_plain_equals_reference(n):
    """The bucketed plain sweep == the reference's bucketed oracle, its
    dense oracle and its windowed Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(n)
    B, deg = 8, 7
    state = sweep_state(rng, B, n, deg)
    dist, mrank, prop, alive, es, ew, rank = state
    lay = sweep_layout(torch.as_tensor(es), torch.as_tensor(ew), bb=B,
                       max_window=128)
    ref_lay = ref_ell.sweep_layout(es, ew, max_window=128)
    assert lay.num_windows == ref_lay.num_windows > 1
    t = as_torch(state)
    pd, pm = ell_sweep_bucketed_plain(t[0], t[1], t[2], t[3], lay, t[6])
    j = [jnp.asarray(x) for x in state]
    wants = [ref_ell.ell_sweep_bucketed_ref(j[0], j[1], j[2], j[1],
                                            ref_lay, j[6]),
             ref_sweep_ref(j[0], j[1], j[2], j[1], j[4], j[5], j[6]),
             ref_ell_sweep(*j, use_kernel=True, interpret=True,
                           layout=ref_lay)]
    for rd, rm in wants:
        assert np.array_equal(pd.numpy(), np.asarray(rd))
        assert np.array_equal(pm.numpy(), np.asarray(rm))


def test_bucketed_plain_row_blocks(monkeypatch):
    """Row blocking of the plain version changes nothing."""
    rng = np.random.default_rng(4)
    state = as_torch(sweep_state(rng, 3, 900, 11))
    lay = sweep_layout(state[4], state[5], bb=3, max_window=256)
    whole = ell_sweep_bucketed_plain(*state[:4], lay, state[6])
    monkeypatch.setattr(port_ref, "BLOCK_ELEMS", 1)  # one tile per block
    blocked = ell_sweep_bucketed_plain(*state[:4], lay, state[6])
    assert torch.equal(whole[0], blocked[0])
    assert torch.equal(whole[1], blocked[1])


def test_cpu_dispatch_never_launches():
    """On CPU tensors `ell_sweep` runs the plain versions — bucketed
    when given a multi-window layout — and launches nothing; without a
    layout the CPU builds none."""
    rng = np.random.default_rng(5)
    t = as_torch(sweep_state(rng, 4, 300, 6))
    assert resolve_sweep_backend(t[4], t[5], 4) is None
    lay = sweep_layout(t[4], t[5], bb=4, max_window=128)
    one = sweep_layout(t[4], t[5], bb=4, max_window=512)
    assert one is None and resolve_sweep_backend(t[4], t[5], 4,
                                                 layout=lay) is lay
    before = [k.launches for k in all_kernels()]
    got = ell_sweep(*t, layout=lay)
    want = ell_sweep_bucketed_plain(*t[:4], lay, t[6])
    dense = ell_sweep(*t)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], dense[0]) and torch.equal(got[1], dense[1])
    assert [k.launches for k in all_kernels()] == before


def test_windowed_wrapper_refuses_what_it_cannot_take():
    rng = np.random.default_rng(0)
    t = as_torch(sweep_state(rng, 2, 300, 3))
    lay = sweep_layout(t[4], t[5], bb=2, max_window=128)
    with pytest.raises(ValueError, match="CUDA"):
        ell_relax_windowed(*t[:4], lay, t[6])
    with pytest.raises(ValueError, match="n=300"):
        ell_relax_windowed(t[0][:, :10], t[1][:, :10], t[2][:, :10], t[3],
                           lay, t[6][:10])
    assert WINDOWED_KERNEL.launches == 0


def test_layout_cache_keyed_by_tensor_identity():
    rng = np.random.default_rng(1)
    es, ew = (torch.as_tensor(x) for x in _rand_ell(rng, 300, 4))
    a = sweep_layout(es, ew, bb=2, max_window=128)
    assert sweep_layout(es, ew, bb=2, max_window=128) is a
    assert sweep_layout(es.clone(), ew, bb=2, max_window=128) is not a


@pytest.mark.parametrize("gated,blocked", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_windowed_fixpoint_matches_reference(monkeypatch, gated, blocked):
    """The driver over a forced multi-window layout == the reference
    driver over its windowed Pallas kernel (interpret mode): dist,
    mrank, sweeps and explored, gated and ungated, with rank-block
    pruning."""
    g = rg.scale_free(300, attach=2, seed=4)
    rank = degree_ranking(g)
    roots = np.arange(0, g.n, 23, dtype=np.int32)
    es, ew = torch.as_tensor(g.ell_src), torch.as_tensor(g.ell_w)
    pr = torch.as_tensor(rank)
    force_window(monkeypatch, 128, len(roots))
    lay = relax.ell_layout(es, ew, batch=len(roots))
    assert lay is not None and lay.num_windows > 1
    pst = relax.batched_sssp_maxrank(
        es, ew, pr, torch.as_tensor(roots), check_every=4,
        frontier_gating=gated, layout=lay,
        block_fn=relax.rank_block(pr) if blocked else None)
    j = jnp.asarray
    jr = j(rank)
    ref_lay = ref_relax.ell_layout(j(g.ell_src), j(g.ell_w), max_window=128)
    rst = ref_relax.batched_sssp_maxrank(
        j(g.ell_src), j(g.ell_w), jr, j(roots), check_every=4,
        frontier_gating=gated, use_kernel=True, layout=ref_lay,
        block_fn=ref_relax.rank_block(jr) if blocked else None)
    assert np.array_equal(pst.dist.numpy(), np.asarray(rst.dist))
    assert np.array_equal(pst.mrank.numpy(), np.asarray(rst.mrank))
    assert pst.sweeps == int(rst.sweeps)
    assert np.array_equal(pst.explored.numpy(), np.asarray(rst.explored))


def test_windowed_build_equals_reference(monkeypatch):
    """A CPU PLaNT build with forced windows gives the reference's label
    tables (hubs, dist, count, slot order, padding) under its windowed
    kernel, and its report records the windowing."""
    import jax

    from repro.index import BuildPlan as RefPlan
    from repro.index import build as ref_build
    from repro_torch.index import BuildPlan, BuildReport, build
    g = rg.scale_free(300, attach=2, seed=0)
    rank = degree_ranking(g)
    unforced = build(interop.graph(g), rank,
                     BuildPlan(algo="plant", batch=64), device="cpu")
    assert unforced.report.notes == []
    with monkeypatch.context() as m:
        force_window(m, 256, 64)
        port = build(interop.graph(g), rank,
                     BuildPlan(algo="plant", batch=64), device="cpu")
    monkeypatch.setenv(ref_ell.ELL_RELAX_ENV_VAR, "kernel")
    monkeypatch.setenv(ref_ell.VMEM_BUDGET_ENV_VAR, "16k")  # window 256
    ref_ell.clear_layout_cache()
    jax.clear_caches()
    ref = ref_build(g, rank, RefPlan(algo="plant", batch=64))
    jax.clear_caches()
    ref_ell.clear_layout_cache()
    assert any("source-windowed" in x for x in ref.report.notes)
    for a, b in zip(port.table, ref.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    plan = window_plan(g.n, max_window=256)
    assert plan.num_windows == 2
    notes = port.report.notes
    assert any("source-windowed" in x and f"window={plan.window}" in x
               for x in notes)
    assert BuildReport.from_dict(port.report.to_dict()).notes == notes
    for a, b in zip(port.table, unforced.table):
        assert torch.equal(a, b)


def test_reference_format_arrays_built_on_first_use():
    """The kernel's segments are built with the layout; the padded
    reference-format arrays only when something reads them."""
    rng = np.random.default_rng(9)
    es, ew = (torch.as_tensor(x) for x in _rand_ell(rng, 300, 5))
    lay = build_bucketed_ell(es, ew, window_plan(300, max_window=128))
    assert lay._padded is None
    t = as_torch(sweep_state(rng, 2, 300, 5))
    ell_sweep(*t[:4], es, ew, t[6], layout=lay)
    assert lay._padded is not None and lay.src.shape[0] == lay.n_pad


def test_route_resolved_once_per_fixpoint(monkeypatch):
    """The driver reads the L2 once per call, not once per sweep, and
    its sweeps run the route it resolved."""
    g = rg.scale_free(300, attach=2, seed=4)
    es, ew = torch.as_tensor(g.ell_src), torch.as_tensor(g.ell_w)
    roots = torch.arange(0, 16, dtype=torch.int32)
    reads = []

    def l2(device):
        reads.append(device)
        return 2 * 8 * 16 * 128                 # windows of 128 at B = 16
    monkeypatch.setattr(port_layout, "l2_bytes", l2)
    port_layout.clear_layout_cache()
    st = relax.batched_sssp_maxrank(es, ew, torch.as_tensor(
        degree_ranking(g)), roots)
    assert st.sweeps > 4 and 0 < len(reads) <= 2
    assert port_layout._cache                   # it built the layout
    port_layout.clear_layout_cache()
