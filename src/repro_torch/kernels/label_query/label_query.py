"""Wrapper of the hand-written CUDA label-intersection kernel
(``csrc/label_query.cu``).

Two forms of one kernel, each one launch on the current stream:

- `label_query_rows`: the serving form. It reads the query's two rows
  straight from a label table at int64 ids, each row bounded by its
  count; `label_query_pair_rows` is the same launch with the u-side
  rows read from one table and the v-side rows from another (a
  directed query: ``L_out[u]`` against ``L_in[v]``);
- `label_query`: the operand form, row q of four ``[Q, L]`` operands.

All take CUDA tensors only; they check device, dtype, shape and
contiguity, allocate the outputs and raise if the launch was refused.
``KERNEL.launches`` counts launches. `launch_geometry` is the launch's
shape: a pure function of ``(Q, L, sm_count)`` that the CPU tests call.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import torch

from repro_torch.kernels.cuda import (CudaKernel, check_tensors,
                                      current_stream, on_device, sm_count)

KERNEL = CudaKernel(
    "label_query",
    Path(__file__).resolve().parent / "csrc" / "label_query.cu",
    argtypes=[ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 2
    + [ctypes.c_int] * 3 + [ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_void_p])

WARP = 32
#: rows at most this wide share a warp between queries (the short path)
SHORT_L = 32
#: the fewest lanes a query's group takes on the short path
MIN_GROUP = 4
#: warps of a block (the kernel's ``kMaxWarps``)
MAX_WARPS = 4


@lru_cache(maxsize=256)
def launch_geometry(Q: int, L: int, sms: int):
    """``(g, warps, threads, blocks)`` of one launch over ``Q`` queries of
    width ``L`` on a card of ``sms`` SMs.

    g is the lanes a query takes: ``clamp(next_pow2(L), 4, 32)`` for
    short rows (L <= `SHORT_L`), so a warp serves ``32 / g`` queries, and
    a whole warp for longer rows. A block has `MAX_WARPS` warps unless
    that leaves fewer blocks than SMs, when it halves down to one warp,
    so a small batch still spreads over the card.
    """
    next_pow2 = 1 << max(0, L - 1).bit_length()
    g = WARP if L > SHORT_L else min(WARP, max(MIN_GROUP, next_pow2))
    per_warp = WARP // g
    warps = MAX_WARPS
    while warps > 1 and -(-Q // (per_warp * warps)) < sms:
        warps //= 2
    return g, warps, WARP * warps, -(-Q // (per_warp * warps))


def lane_query(Q: int, g: int, warps: int, block: int, thread: int):
    """``(q, k)``: the query that thread ``thread`` of block ``block``
    serves (None past Q) and its slot in the query's group: the kernel's
    index arithmetic, for the tests."""
    warp, lane = divmod(thread, WARP)
    q = (block * warps + warp) * (WARP // g) + lane // g
    return (q if q < Q else None), lane % g


def _launch(hu, du, cu, iu, hv, dv, cv, iv, n: int, Q: int, L: int):
    dev = hu.device
    out_d = torch.empty(Q, dtype=torch.float32, device=dev)
    out_h = torch.empty(Q, dtype=torch.int32, device=dev)
    if Q:
        g, warps, _, blocks = launch_geometry(Q, L, sm_count(dev))
        vec = L % 4 == 0 and hv.data_ptr() % 16 == 0 \
            and dv.data_ptr() % 16 == 0
        ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
        with on_device(dev):
            KERNEL.launch(hu.data_ptr(), du.data_ptr(), ptr(cu), ptr(iu),
                          hv.data_ptr(), dv.data_ptr(), ptr(cv), ptr(iv),
                          out_d.data_ptr(), out_h.data_ptr(), n, Q, L, g,
                          warps, blocks, int(vec), current_stream(dev))
    return out_d, out_h


def label_query_rows(hubs, dist, count, u, v):
    """(dist f32 [Q], hub i32 [Q]) of the queries ``(u[q], v[q])`` over a
    label table on the card, in one launch that reads the rows itself.

    hubs i32 / dist f32 [n, L], count i32 [n]; u, v int64 [Q]. A negative
    id wraps once, as ``hubs[u]`` does; an id outside ``[-n, n)`` is a
    device-side assert. Each row is read only below its count.

    Precondition: every slot at or past ``count`` holds ``(-1, +inf)``
    and ``0 <= count <= L``, as every table the port builds or loads
    does (`repro_torch.core.labels.check_padding`, which `DenseStore`
    runs). On such a table the answers equal the plain version's over
    the padded rows, ``label_query_ref(hubs[u], dist[u], hubs[v],
    dist[v])``, bit for bit.
    """
    n, L = hubs.shape if hubs.dim() == 2 else (-1, -1)
    Q = u.shape[0] if u.dim() == 1 else -1
    check_tensors("label_query", hubs.device,
                  [("hubs", hubs, torch.int32, (n, L)),
                   ("dist", dist, torch.float32, (n, L)),
                   ("count", count, torch.int32, (n,)),
                   ("u", u, torch.int64, (Q,)),
                   ("v", v, torch.int64, (Q,))])
    return _launch(hubs, dist, count, u, hubs, dist, count, v, n, Q, L)


def check_same_shape(table_u, table_v) -> None:
    """Raise ValueError unless the two label tables are both ``[n, L]``
    of one n and one L (a two-table query's precondition)."""
    if table_u.hubs.shape != table_v.hubs.shape:
        raise ValueError(
            f"label_query: the two tables differ in shape "
            f"({tuple(table_u.hubs.shape)} against "
            f"{tuple(table_v.hubs.shape)})")


def label_query_pair_rows(table_u, table_v, u, v):
    """(dist f32 [Q], hub i32 [Q]) of the queries ``(u[q], v[q])`` with
    u's row read from ``table_u`` and v's from ``table_v`` (two label
    tables on the card of one shape ``[n, L]``), in one launch: the
    directed query over ``L_out[u]`` and ``L_in[v]``. The witness is the
    first row-major argmin's u-side hub, as in the reference's
    ``query_directed``. Both tables must keep `label_query_rows`'
    precondition (``(-1, +inf)`` at and past each row's count)."""
    check_same_shape(table_u, table_v)
    n, L = table_u.hubs.shape if table_u.hubs.dim() == 2 else (-1, -1)
    Q = u.shape[0] if u.dim() == 1 else -1
    check_tensors("label_query", table_u.hubs.device,
                  [("hubs_u", table_u.hubs, torch.int32, (n, L)),
                   ("dist_u", table_u.dist, torch.float32, (n, L)),
                   ("count_u", table_u.count, torch.int32, (n,)),
                   ("hubs_v", table_v.hubs, torch.int32, (n, L)),
                   ("dist_v", table_v.dist, torch.float32, (n, L)),
                   ("count_v", table_v.count, torch.int32, (n,)),
                   ("u", u, torch.int64, (Q,)),
                   ("v", v, torch.int64, (Q,))])
    return _launch(table_u.hubs, table_u.dist, table_u.count, u,
                   table_v.hubs, table_v.dist, table_v.count, v, n, Q, L)


def label_query(hubs_u, dist_u, hubs_v, dist_v):
    """(dist f32 [Q], hub i32 [Q]) for label rows hubs_* i32 /
    dist_* f32 [Q, L] on the card, every slot read; any Q and L."""
    Q, L = hubs_u.shape
    check_tensors("label_query", hubs_u.device,
                  [(name, t, dtype, (Q, L)) for name, t, dtype in
                   (("hubs_u", hubs_u, torch.int32),
                    ("dist_u", dist_u, torch.float32),
                    ("hubs_v", hubs_v, torch.int32),
                    ("dist_v", dist_v, torch.float32))])
    return _launch(hubs_u, dist_u, None, None, hubs_v, dist_v, None, None,
                   Q, Q, L)
