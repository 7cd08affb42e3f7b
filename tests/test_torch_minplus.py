"""The port's dense-block PLaNT and its (min, +) product against the
reference package.

Exact comparisons throughout (integral f32 weights, so min, + and max
are exact): ``minplus_plain`` against the reference's jnp oracle and its
Pallas kernel in interpret mode (through the compat dispatch, as the
reference's own tests run it) at ragged shapes, the all-unreachable and
tie cases; ``dense_weights``; and ``plant_fixpoint_dense`` against both
the reference's and the port's own ELL engine.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as rg
from repro.graphs.ranking import degree_ranking
from repro.kernels import minplus as ref_mp
from repro_torch import interop
from repro_torch.kernels import all_kernels
from repro_torch.kernels.minplus import (KERNEL, dense_weights, minplus,
                                         minplus_plain, minplus_product,
                                         plant_fixpoint_dense,
                                         plant_sweep_dense)
from repro_torch.kernels.minplus import ref as port_ref
from repro_torch.sssp import batched_sssp_maxrank

torch.set_num_threads(1)


def rand_minplus(rng, B, K, N, density=0.3, maxw=10):
    dist = np.where(rng.random((B, K)) < 0.6,
                    rng.integers(0, maxw, (B, K)), np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 100, (B, K)),
                     -1).astype(np.int32)
    w = np.where(rng.random((K, N)) < density,
                 rng.integers(1, maxw, (K, N)), np.inf).astype(np.float32)
    return dist, mrank, w


@pytest.mark.parametrize("B,K,N", [(1, 1, 1), (3, 5, 7), (8, 128, 128),
                                   (16, 130, 250), (5, 260, 13)])
@pytest.mark.parametrize("seed", [0, 1])
def test_minplus_plain_matches_reference(B, K, N, seed):
    ops = rand_minplus(np.random.default_rng(seed), B, K, N)
    pd, pm = minplus_plain(*(torch.as_tensor(x) for x in ops))
    j = [jnp.asarray(x) for x in ops]
    for rd, rm in (ref_mp.minplus_ref(*j), ref_mp.minplus_padded(*j)):
        assert np.array_equal(pd.numpy(), np.asarray(rd))
        assert np.array_equal(pm.numpy(), np.asarray(rm))


def test_minplus_plain_chunked_fold_is_exact(monkeypatch):
    """Folding over K one row at a time gives the one-shot result."""
    ops = [torch.as_tensor(x) for x in
           rand_minplus(np.random.default_rng(3), 6, 97, 41, density=0.5,
                        maxw=4)]
    whole = minplus_plain(*ops)
    monkeypatch.setattr(port_ref, "CHUNK_ELEMS", 1)
    chunked = minplus_plain(*ops)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


def test_minplus_all_unreachable():
    od, om = minplus_product(torch.full((8, 128), torch.inf),
                             torch.full((8, 128), -1, dtype=torch.int32),
                             torch.full((128, 128), torch.inf))
    assert not torch.isfinite(od).any() and (om == -1).all()
    od, om = minplus_plain(torch.zeros(3, 0), torch.zeros(3, 0).int(),
                           torch.zeros(0, 5))
    assert not torch.isfinite(od).any() and (om == -1).all()


def test_minplus_tie_break_takes_max_rank():
    od, om = minplus_product(torch.tensor([[1.0, 1.0]]),
                             torch.tensor([[7, 9]], dtype=torch.int32),
                             torch.tensor([[2.0], [2.0]]))
    assert od[0, 0] == 3.0 and om[0, 0] == 9


def test_cpu_dispatch_never_launches_and_wrapper_refuses():
    ops = [torch.as_tensor(x) for x in
           rand_minplus(np.random.default_rng(0), 4, 9, 5)]
    before = [k.launches for k in all_kernels()]
    got = minplus_product(*ops)
    want = minplus_plain(*ops)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert [k.launches for k in all_kernels()] == before
    with pytest.raises(ValueError, match="CUDA"):
        minplus(*ops)
    with pytest.raises(ValueError, match="CUDA|float32"):
        minplus(ops[0].double(), ops[1], ops[2])
    assert KERNEL.launches == 0


@pytest.mark.parametrize("kind", ["scalefree", "grid"])
def test_dense_weights_equal_reference(kind):
    g = (rg.scale_free(60, attach=2, seed=3) if kind == "scalefree"
         else rg.grid_road(5, 6, seed=1))
    got = dense_weights(interop.graph(g), device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(ref_mp.dense_weights(g)))


def test_plant_fixpoint_dense_equals_reference_and_ell_engine():
    g = rg.scale_free(60, attach=2, seed=3)
    rank = degree_ranking(g)
    roots = np.arange(8, dtype=np.int32)
    w = dense_weights(interop.graph(g), device="cpu")
    dist, mrank, emit = plant_fixpoint_dense(w, torch.as_tensor(rank),
                                             torch.as_tensor(roots))
    rd, rm, re = ref_mp.plant_fixpoint_dense(
        ref_mp.dense_weights(g), jnp.asarray(rank), jnp.asarray(roots))
    assert np.array_equal(dist.numpy(), np.asarray(rd))
    assert np.array_equal(mrank.numpy(), np.asarray(rm))
    assert np.array_equal(emit.numpy(), np.asarray(re))
    st = batched_sssp_maxrank(torch.as_tensor(g.ell_src),
                              torch.as_tensor(g.ell_w),
                              torch.as_tensor(rank), torch.as_tensor(roots))
    assert torch.equal(dist, st.dist) and torch.equal(mrank, st.mrank)
    root_rank = torch.as_tensor(rank)[roots][:, None]
    assert torch.equal(emit, (st.mrank == root_rank)
                       & torch.isfinite(st.dist))


def test_plant_sweep_dense_equals_reference():
    g = rg.scale_free(40, attach=3, seed=5)
    rank = degree_ranking(g).astype(np.int32)
    rng = np.random.default_rng(2)
    dist = np.where(rng.random((5, g.n)) < 0.5, rng.integers(0, 6, (5, g.n)),
                    np.inf).astype(np.float32)
    mrank = np.where(np.isfinite(dist), rng.integers(0, 40, (5, g.n)),
                     -1).astype(np.int32)
    w = dense_weights(interop.graph(g), device="cpu")
    pd, pm = plant_sweep_dense(torch.as_tensor(dist),
                               torch.as_tensor(mrank), w,
                               torch.as_tensor(rank))
    rd, rm = ref_mp.plant_sweep_dense(jnp.asarray(dist),
                                      jnp.asarray(mrank),
                                      ref_mp.dense_weights(g),
                                      jnp.asarray(rank))
    assert np.array_equal(pd.numpy(), np.asarray(rd))
    assert np.array_equal(pm.numpy(), np.asarray(rm))
