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
   frontier gating on and off.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as rg
from repro.graphs.ranking import degree_ranking, random_ranking
from repro.kernels.ell_relax import ell_sweep as ref_ell_sweep
from repro.kernels.ell_relax import ell_sweep_ref as ref_sweep_ref
from repro.sssp import relax as ref_relax
from repro_torch.kernels.ell_relax import (KERNEL, ell_relax, ell_sweep,
                                           ell_sweep_plain, ell_sweep_ref)
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

