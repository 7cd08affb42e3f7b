"""The port's label tables and label intersection against the
reference package.

- ``query_pairs`` / ``label_query_ref`` return (dist, hub) equal to the
  reference's ``labels.query_pairs``, and dist equal to its
  ``label_query_ref`` and its Pallas kernel in interpret mode: over
  disjoint rows (+inf, -1), equal-distance ties across hubs (the first
  row-major witness wins), widths that are not multiples of 128, and
  widths past the reference kernel's 512 wall;
- ``insert_batch`` equals the reference's drop-mode scatter, overflow
  flag and count clamp;
- the plain ``query_table`` equals the reference's ``query_pairs`` with
  negative ids at the widths the card's kernel splits on;
- the padding contract the card's table-form kernel relies on, ``(-1,
  +inf)`` at and past each row's count, holds for tables the port
  builds, for artifacts the reference saved and for ``interop``
  tables, and ``DenseStore`` refuses a table that breaks it;
- the kernel's launch geometry (lanes a query, warps a block, blocks)
  as a pure function: each query served by exactly one group whose
  lanes cover its slots.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.graphs as rg
from repro.core import labels as ref_labels
from repro.graphs.ranking import betweenness_ranking
from repro.index import BuildPlan as RefPlan
from repro.index import build as ref_build
from repro.kernels.label_query import label_query_padded
from repro.kernels.label_query import label_query_ref as ref_lq_ref
from repro_torch import interop
from repro_torch.core import labels
from repro_torch.index import BuildPlan, CHLIndex, build
from repro_torch.index.store import DenseStore
from repro_torch.kernels.label_query import (KERNEL, label_query,
                                             label_query_ref,
                                             label_query_rows, query_table)
from repro_torch.kernels.label_query.label_query import (MAX_WARPS,
                                                         SHORT_L,
                                                         launch_geometry,
                                                         lane_query)

torch.set_num_threads(1)


def random_table(rng, n, L, hubs=12):
    """A label table with few distinct hubs (many ties), -1 padding
    after ``count``, and a few empty rows."""
    count = rng.integers(0, L + 1, n).astype(np.int32)
    count[::9] = 0
    slot = np.arange(L)[None, :] < count[:, None]
    h = np.where(slot, rng.integers(0, hubs, (n, L)), -1).astype(np.int32)
    d = np.where(slot, rng.integers(0, 5, (n, L)),
                 np.inf).astype(np.float32)
    return h, d, count


def pairs(rng, n, Q):
    return (rng.integers(0, n, Q).astype(np.int32),
            rng.integers(0, n, Q).astype(np.int32))


@pytest.mark.parametrize("n,L,Q", [(20, 1, 16), (40, 5, 64),
                                   (30, 130, 48), (12, 600, 20)])
def test_query_pairs_equals_reference(n, L, Q):
    rng = np.random.default_rng(n + L)
    h, d, c = random_table(rng, n, L)
    u, v = pairs(rng, n, Q)
    t = interop.label_table(h, d, c, "cpu")
    pd, ph = labels.query_pairs(t, torch.as_tensor(u), torch.as_tensor(v))
    rt = ref_labels.LabelTable(jnp.asarray(h), jnp.asarray(d),
                               jnp.asarray(c))
    rd, rh = ref_labels.query_pairs(rt, jnp.asarray(u), jnp.asarray(v))
    assert np.array_equal(pd.numpy(), np.asarray(rd))
    assert np.array_equal(ph.numpy(), np.asarray(rh))
    assert (ph.numpy()[~np.isfinite(pd.numpy())] == -1).all()
    # the serving entry point on CPU tensors is the same plain version
    qd, qh = query_table(t, torch.as_tensor(u).long(),
                         torch.as_tensor(v).long())
    assert torch.equal(qd, pd) and torch.equal(qh, ph)


@pytest.mark.parametrize("Q,L", [(5, 3), (33, 70), (16, 130), (9, 520)])
def test_dist_equals_reference_kernel_and_oracle(Q, L):
    rng = np.random.default_rng(Q * L)

    def side():
        hubs = rng.integers(-1, 30, (Q, L)).astype(np.int32)
        dist = np.where(hubs >= 0, rng.integers(0, 20, (Q, L)),
                        np.inf).astype(np.float32)
        return hubs, dist

    hu, du = side()
    hv, dv = side()
    hv[0] = np.where(hv[0] >= 0, hv[0] + 100, -1)          # disjoint row
    before = KERNEL.launches
    pd, ph = label_query_ref(*(torch.as_tensor(x)
                               for x in (hu, du, hv, dv)))
    args = [jnp.asarray(x) for x in (hu, du, hv, dv)]
    assert np.array_equal(pd.numpy(), np.asarray(ref_lq_ref(*args)))
    # L > 512 routes to the reference oracle inside the reference ops
    kern = label_query_padded(*args, interpret=True)
    assert np.array_equal(pd.numpy(), np.asarray(kern))
    assert np.isinf(pd[0].item()) and ph[0].item() == -1
    assert KERNEL.launches == before


def test_tie_break_takes_first_row_major_hub():
    """Two hubs attain the same distance: the hub of the first (i, j)
    in row-major order is the witness."""
    hubs = np.array([[7, 3, 5, -1], [5, 3, 7, 9]], np.int32)
    dist = np.array([[4, 1, 2, np.inf], [3, 4, 1, 0]], np.float32)
    count = np.array([3, 4], np.int32)
    u, v = np.array([0], np.int32), np.array([1], np.int32)
    t = interop.label_table(hubs, dist, count, "cpu")
    d, h = labels.query_pairs(t, torch.as_tensor(u), torch.as_tensor(v))
    assert d.item() == 5.0 and h.item() == 7   # 7: 4+1, 3: 1+4, 5: 2+3
    rd, rh = ref_labels.query_pairs(
        ref_labels.LabelTable(*(jnp.asarray(x) for x in (hubs, dist,
                                                          count))),
        jnp.asarray(u), jnp.asarray(v))
    assert d.item() == float(rd[0]) and h.item() == int(rh[0])


@pytest.mark.parametrize("cap", [3, 8])
def test_insert_batch_drop_and_clamp_match_reference(cap):
    rng = np.random.default_rng(cap)
    n, B = 30, 6
    t = labels.empty(n, cap, "cpu")
    rt = ref_labels.empty(n, cap)
    for step in range(3):
        roots = rng.integers(0, n, B).astype(np.int32)
        emit = rng.random((B, n)) < 0.4
        dists = rng.integers(0, 50, (B, n)).astype(np.float32)
        t, ovf = labels.insert_batch(t, torch.as_tensor(roots),
                                     torch.as_tensor(emit),
                                     torch.as_tensor(dists))
        rt, rovf = ref_labels.insert_batch(rt, jnp.asarray(roots),
                                           jnp.asarray(emit),
                                           jnp.asarray(dists))
        assert bool(ovf) == bool(rovf)
        for a, b in zip(t, rt):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert labels.total_labels(t) == ref_labels.total_labels(rt)


def test_default_cap_matches_reference():
    for n in (1, 7, 100, 4096, 16_777_216):
        assert labels.default_cap(n) == ref_labels.default_cap(n)


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        label_query(x, x.float(), x, x.float())



@pytest.mark.parametrize("L", [1, 8, 32, 288])
def test_plain_query_table_equals_reference_with_negative_ids(L):
    """The widths around the kernel's short/long split; ids in [-n, n)
    wrap in both packages; u == v pairs included."""
    rng = np.random.default_rng(100 + L)
    n, Q = 37, 96
    h, d, c = random_table(rng, n, L, hubs=max(4, L // 3))
    u = rng.integers(-n, n, Q).astype(np.int64)
    v = rng.integers(-n, n, Q).astype(np.int64)
    v[::6] = u[::6]
    t = interop.label_table(h, d, c, "cpu")
    KERNEL.launches = 0
    pd, ph = query_table(t, torch.as_tensor(u), torch.as_tensor(v))
    assert KERNEL.launches == 0
    rt = ref_labels.LabelTable(jnp.asarray(h), jnp.asarray(d),
                               jnp.asarray(c))
    rd, rh = ref_labels.query_pairs(rt, jnp.asarray(u), jnp.asarray(v))
    assert np.array_equal(pd.numpy(), np.asarray(rd))
    assert np.array_equal(ph.numpy(), np.asarray(rh))
    assert (u < 0).any() and (v < 0).any()
    # u == v over a non-empty row always meets its own hubs
    same = (u == v) & (c[u] > 0)
    assert np.isfinite(pd.numpy()[same]).all()


def assert_padding_contract(hubs, dist, count):
    hubs, dist, count = (np.asarray(x) for x in (hubs, dist, count))
    past = np.arange(hubs.shape[1])[None, :] >= count[:, None]
    assert (hubs[past] == -1).all() and np.isinf(dist[past]).all()
    assert ((count >= 0) & (count <= hubs.shape[1])).all()


@pytest.fixture(scope="module")
def reference_index():
    g = rg.grid_road(6, 7, seed=4)
    rank = betweenness_ranking(g, samples=6)
    return ref_build(g, rank, RefPlan(algo="plant", batch=8)), g, rank


@pytest.mark.parametrize("source", ["port-build", "reference-artifact",
                                    "interop"])
def test_tables_keep_the_padding_contract(source, reference_index,
                                          tmp_path):
    ref, g, rank = reference_index
    if source == "port-build":
        t = build(interop.graph(g), rank, BuildPlan(algo="plant", batch=8),
                  device="cpu").table
    elif source == "reference-artifact":
        d = ref.save(str(tmp_path / "ref"))
        t = CHLIndex.load(d, rank=rank, device="cpu").table
    else:
        t = interop.label_table(*(np.array(x) for x in ref.table), "cpu")
    assert_padding_contract(*(x.numpy() for x in t))
    assert_padding_contract(*ref.table)
    for a, b in zip(t, ref.table):
        assert np.array_equal(a.numpy(), np.asarray(b))
    labels.check_padding(t)
    assert int(t.count.max()) < t.cap    # some padding to check


@pytest.mark.parametrize("fault", ["hub", "dist", "count-high",
                                   "count-low"])
def test_dense_store_refuses_broken_padding(fault):
    rng = np.random.default_rng(5)
    h, d, c = random_table(rng, 20, 6)
    c[3] = 4
    if fault == "hub":
        h[3, 5] = 7
    elif fault == "dist":
        d[3, 4] = 2.0
    elif fault == "count-high":
        c[3] = 7
    else:
        c[3] = -1
    t = interop.label_table(h, d, c, "cpu")
    with pytest.raises(ValueError, match="padding contract"):
        DenseStore(t)
    with pytest.raises(ValueError, match="padding contract"):
        labels.check_padding(t)


H100_SMS = 132


@pytest.mark.parametrize("L,g", [(1, 4), (3, 4), (4, 4), (5, 8), (8, 8),
                                 (9, 16), (31, 32), (32, 32), (33, 32),
                                 (288, 32), (700, 32)])
@pytest.mark.parametrize("Q", [1, 45, 1000, 65_537])
def test_launch_geometry_groups(L, g, Q):
    """Lanes a query (g), warps a block and blocks at the widths around
    each group size, the short/long split at L = 32 and the parity
    widths; Q not a multiple of the queries a block serves."""
    gg, warps, threads, blocks = launch_geometry(Q, L, H100_SMS)
    assert gg == g and threads == 32 * warps
    per_block = warps * (32 // g)
    assert blocks == -(-Q // per_block)
    # a block of MAX_WARPS unless that leaves SMs without a block
    if warps < MAX_WARPS:
        assert -(-Q // (2 * per_block)) < H100_SMS


@pytest.mark.parametrize("Q,L,sms", [(1, 8, 132), (45, 3, 132),
                                     (1000, 8, 132), (45, 33, 132),
                                     (77, 9, 1), (130, 1, 1),
                                     (9, 700, 1)])
def test_each_query_served_by_one_group(Q, L, sms):
    """Every query is served by exactly one group of g lanes whose slots
    are 0..g-1 (g >= L on the short path, so every u-slot has a lane);
    lanes past Q serve nothing."""
    g, warps, threads, blocks = launch_geometry(Q, L, sms)
    seen = {}
    for blk in range(blocks):
        for t in range(threads):
            q, k = lane_query(Q, g, warps, blk, t)
            if q is not None:
                seen.setdefault(q, []).append((blk, t // 32, k))
    assert sorted(seen) == list(range(Q))
    for q, lanes in seen.items():
        assert sorted(k for _, _, k in lanes) == list(range(g))
        assert len({(b, w) for b, w, _ in lanes}) == 1   # one warp
    assert L > 32 or g >= L


def test_table_kernel_refuses_cpu_tensors():
    t = labels.empty(4, 3, "cpu")
    ids = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        label_query_rows(t.hubs, t.dist, t.count, ids, ids)


def test_geometry_constants_match_kernel_source():
    """The wrapper's warps a block and short/long split are the
    kernel's: ``kMaxWarps`` and its ``L > 32`` branch."""
    src = Path(KERNEL.source).read_text()
    assert int(re.search(r"constexpr int kMaxWarps = (\d+);",
                         src).group(1)) == MAX_WARPS
    assert f"if (L > {SHORT_L})" in src
