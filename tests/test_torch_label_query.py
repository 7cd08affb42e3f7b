"""The port's label tables and label intersection against the
reference package.

- ``query_pairs`` / ``label_query_ref`` return (dist, hub) equal to the
  reference's ``labels.query_pairs``, and dist equal to its
  ``label_query_ref`` and its Pallas kernel in interpret mode: over
  disjoint rows (+inf, -1), equal-distance ties across hubs (the first
  row-major witness wins), widths that are not multiples of 128, and
  widths past the reference kernel's 512 wall;
- ``insert_batch`` equals the reference's drop-mode scatter, overflow
  flag and count clamp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import labels as ref_labels
from repro.kernels.label_query import label_query_padded
from repro.kernels.label_query import label_query_ref as ref_lq_ref
from repro_torch import interop
from repro_torch.core import labels
from repro_torch.kernels.label_query import (KERNEL, label_query,
                                             label_query_ref, query_table)

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

