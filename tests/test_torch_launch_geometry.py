"""The launch geometry of the port's dense relaxation kernel and its
(min, +) kernel, as pure functions, and the wrappers' refusals on the
CPU.

- `ell_relax.launch_geometry`: the trees a thread takes (G) as a
  function of (B, n, sm_count); every (tree, vertex) pair relaxed by
  exactly one thread, and threads past the tail idle;
- `minplus.launch_geometry`: the grid and its waves; every output
  stored by exactly one thread, and ragged tails masked;
- the constants the wrappers mirror equal the kernels' sources;
- both wrappers refuse CPU tensors, wrong dtypes and wrong shapes.

Imports nothing of JAX.
"""

import importlib
import re
from collections import Counter
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.ell_relax.ell_relax import (ell_relax,
                                                     launch_geometry,
                                                     work_items)
from repro_torch.kernels.minplus.minplus import (
    launch_geometry as minplus_geometry, minplus, thread_outputs)

# the wrapper modules (their packages re-export functions of the same
# names)
relax_mod = importlib.import_module("repro_torch.kernels.ell_relax.ell_relax")
minplus_mod = importlib.import_module("repro_torch.kernels.minplus.minplus")

H100_SMS = 132


@pytest.mark.parametrize("B,n,sms,G,S", [
    (16, 4096, H100_SMS, 1, 4),        # the exactness build
    (4, 802_816, H100_SMS, 2, 2),      # mid-size road
    (4, 786_432, H100_SMS, 2, 2),      # mid-size random
    (4, 540_000, H100_SMS, 1, 4),      # just below G = 2
    (4, 541_000, H100_SMS, 2, 2),      # just above
    (3, 1_200_000, H100_SMS, 2, 2),    # G = 4 would pass B
    (16, 150_000, H100_SMS, 2, 4),
    (16, 300_000, H100_SMS, 4, 4),
    (4, 16_777_216, H100_SMS, 4, 1),   # the road state
    (1, 16_777_216, H100_SMS, 1, 1),   # one tree: G never passes B
    (1, 1, H100_SMS, 1, 1),
    (3, 5, H100_SMS, 1, 3),
    (33, 1000, H100_SMS, 1, 4),
    (8, 3000, 1, 2, 4),                # a one-SM card takes G sooner
    (8, 5000, 1, 4, 2),
])
def test_ell_relax_tree_group_size(B, n, sms, G, S):
    g, s, threads, blocks = launch_geometry(B, n, sms)
    assert (g, s) == (G, S)
    assert threads == relax_mod.TILE_V * S <= 256
    assert blocks == -(-n // relax_mod.TILE_V) * -(-B // (S * G))


@pytest.mark.parametrize("B,n,sms", [(1, 1, 132), (3, 5, 132),
                                     (16, 200, 132), (33, 130, 132),
                                     (8, 5000, 1), (5, 3000, 1),
                                     (7, 9000, 1), (4, 65, 132)])
def test_ell_relax_covers_each_pair_once(B, n, sms):
    """Every (tree, vertex) pair belongs to exactly one thread of the
    grid, the ragged tile and tree chunk included; a thread past n or
    past B relaxes nothing for it."""
    G, S, threads, blocks = launch_geometry(B, n, sms)
    if sms == 1:
        assert G > 1                    # the one-SM cases take G = 2 and 4
    seen = Counter()
    for blk in range(blocks):
        for t in range(threads):
            items = work_items(B, n, G, S, blk, t)
            assert len(items) <= G
            seen.update(items)
    assert set(seen) == {(b, v) for b in range(B) for v in range(n)}
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("B,N,sms,blocks,waves", [
    (64, 32_768, H100_SMS, 256, 256 / 264),   # the dense block
    (64, 32_769, H100_SMS, 257, 257 / 264),
    (130, 257, H100_SMS, 9, 9 / 264),
    (1, 1, H100_SMS, 1, 1 / 264),
    (65, 128, 1, 2, 1.0),
])
def test_minplus_grid_and_waves(B, N, sms, blocks, waves):
    gx, gy, nb, w = minplus_geometry(B, N, sms)
    assert (gx, gy) == (-(-N // minplus_mod.TN), -(-B // minplus_mod.TB))
    assert nb == blocks and w == pytest.approx(waves)


@pytest.mark.parametrize("B,N", [(1, 1), (63, 127), (64, 128), (65, 129),
                                 (130, 257)])
def test_minplus_stores_each_output_once(B, N):
    gx, gy, _, _ = minplus_geometry(B, N, H100_SMS)
    seen = Counter()
    for by in range(gy):
        for bx in range(gx):
            for t in range(minplus_mod.THREADS):
                seen.update(thread_outputs(B, N, bx, by, t))
    assert set(seen) == {(b, v) for b in range(B) for v in range(N)}
    assert set(seen.values()) == {1}


def _constants(src_name, names, package):
    src = (Path(package.__file__).parent / "csrc" / src_name).read_text()
    out = {}
    for name in names:
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m, name
        out[name] = int(m.group(1))
    return out


def test_mirrored_constants_match_kernel_sources():
    relax = _constants("ell_relax.cu", ("TILE_V", "MAX_SLOTS", "EDGE_SLOTS"),
                       relax_mod)
    assert relax == {"TILE_V": relax_mod.TILE_V,
                     "MAX_SLOTS": relax_mod.MAX_SLOTS,
                     "EDGE_SLOTS": relax_mod.EDGE_SLOTS}
    mp = _constants("minplus.cu", ("TB", "TN", "TK", "NSTAGE",
                                   "BLOCKS_PER_SM", "RI", "CJ"),
                    minplus_mod)
    assert mp == {k: getattr(minplus_mod, k) for k in mp}
    assert minplus_mod.THREADS == (minplus_mod.TN // minplus_mod.CJ) * (
        minplus_mod.TB // minplus_mod.RI)


def _sweep_operands(B=3, n=10, deg=4):
    g = torch.Generator().manual_seed(0)
    return [torch.rand(B, n, generator=g),
            torch.zeros(B, n, dtype=torch.int32),
            torch.rand(B, n, generator=g),
            torch.ones(B, dtype=torch.bool),
            torch.zeros(n, deg, dtype=torch.int32),
            torch.ones(n, deg),
            torch.arange(n, dtype=torch.int32)]


@pytest.mark.parametrize("fault", ["cpu", "dtype", "shape", "ell_shape",
                                   "strided"])
def test_ell_relax_wrapper_refuses(fault):
    ops = _sweep_operands()
    if fault == "dtype":
        ops[0] = ops[0].double()
    elif fault == "shape":
        ops[2] = ops[2][:, :5]
    elif fault == "ell_shape":
        ops[5] = ops[5][:, :2]
    elif fault == "strided":
        ops[1] = torch.zeros(10, 3, dtype=torch.int32).t()
    before = relax_mod.KERNEL.launches
    with pytest.raises(ValueError, match="ell_relax"):
        ell_relax(*ops)
    assert relax_mod.KERNEL.launches == before


@pytest.mark.parametrize("fault", ["cpu", "dtype", "rank_dtype", "shape"])
def test_minplus_wrapper_refuses(fault):
    d, m, w = torch.zeros(3, 4), torch.zeros(3, 4, dtype=torch.int32), \
        torch.zeros(4, 5)
    if fault == "dtype":
        d = d.double()
    elif fault == "rank_dtype":
        m = m.long()
    elif fault == "shape":
        w = w[:3]
    before = minplus_mod.KERNEL.launches
    with pytest.raises(ValueError, match="minplus"):
        minplus(d, m, w)
    assert minplus_mod.KERNEL.launches == before
