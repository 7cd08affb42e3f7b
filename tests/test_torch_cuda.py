"""The port's hand-written kernels on the card (skip without CUDA).

Imports nothing of JAX, so it runs where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

- each kernel equals its plain PyTorch version bit for bit at ragged
  shapes;
- a PLaNT build on the card (kernel path: gated sweeps, stride 4)
  gives the same label table and answers as the CPU build (plain path:
  ungated, stride 1), and its main path launches both kernels.
"""

import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import labels
from repro_torch.graphs import grid_road, random_connected
from repro_torch.graphs.ranking import degree_ranking
from repro_torch.index import BuildPlan, build
from repro_torch.kernels import all_kernels
from repro_torch.kernels.ell_relax import ell_relax, ell_sweep_plain
from repro_torch.kernels.label_query import query_table

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
    kernels = all_kernels()
    for k in kernels:
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
