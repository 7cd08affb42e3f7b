"""Affected-frontier seeding: which trees must be re-planted?

PLaNT trees are independent per root, so a mutation batch only
invalidates the labels of hubs whose shortest-path structure actually
crosses a mutated edge. A tree rooted at ``h`` is **affected** iff
some mutated edge ``{u, v}`` lies on a shortest *or tied* path from
``h``:

- a **delete/reweight** can change the tree only if ``{u, v}`` with
  its OLD weight was on such a path in the OLD graph:
  ``d_old(h,u) + w_old <= d_old(h,v)`` (or symmetrically);
- an **insert/reweight** can change the tree only if ``{u, v}`` with
  its NEW weight lies on such a path in the NEW graph:
  ``d_new(h,u) + w_new <= d_new(h,v)`` (or symmetrically).

The ``<=`` (rather than ``<``) matters: CHL canonicality is decided by
max-rank tie-breaking over *all* shortest paths, so an edge that
merely joins or leaves a tied path can flip an emission even when no
distance changes. Conversely, if no mutated edge satisfies either
test, every shortest path (and every tie) from ``h`` survives with
identical length in both graphs, hence the distance plane *and* the
max-rank plane of ``h`` are unchanged: the tree re-plants to exactly
the same emissions, so skipping it is lossless.

Distances are read from SSSP planes rooted at the *endpoints*
(undirected symmetry: ``d(h,u) == d(u,h)``), computed by
``repro_torch.sssp.relax.batched_sssp`` on the given device (on the
card: the ``ell_relax`` kernel, or ``ell_relax_windowed`` with the
graph's layout when the planes outgrow half the L2), one batched sweep
loop per ~``chunk`` touched endpoints per graph version, whatever the
number of trees that end up affected. Old-graph planes are computed
only for delete/reweight endpoints, new-graph planes only for
insert/reweight endpoints.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import Graph
from repro_torch.sssp.relax import batched_sssp, ell_layout

from .mutations import DELETE, INSERT, REWEIGHT, ResolvedBatch

#: max endpoint-SSSP batch size; bounds the [B, n] plane footprint
DEFAULT_CHUNK = 32
#: smallest launch width; short chunks pad up to the next power of
#: two >= this (duplicate roots: wasted lanes, not wrong answers), so a
#: one-edge mutation pays a 4-lane sweep, not a CHUNK-lane one, and the
#: layouts built stay bounded at log2(CHUNK/BUCKET_MIN)+1 per graph
BUCKET_MIN = 4


def _bucket(k: int, cap: int) -> int:
    b = BUCKET_MIN
    while b < k:
        b <<= 1
    return min(b, cap)


def endpoint_planes(g: Graph, roots: Iterable[int], *,
                    chunk: int = DEFAULT_CHUNK,
                    device: DeviceLike = None) -> Dict[int, np.ndarray]:
    """Host map {vertex: f32 [n] distance plane} for each root, via
    chunked batched sweeps on ``device`` (default: the card)."""
    dev = resolve_device(device)
    roots = np.unique(np.asarray(list(roots), dtype=np.int64))
    planes: Dict[int, np.ndarray] = {}
    if len(roots) == 0:
        return planes
    ell_src = torch.as_tensor(np.asarray(g.ell_src, np.int32), device=dev)
    ell_w = torch.as_tensor(np.asarray(g.ell_w, np.float32), device=dev)
    for lo in range(0, len(roots), chunk):
        part = roots[lo:lo + chunk]
        width = _bucket(len(part), chunk)
        pad = np.pad(part, (0, width - len(part)), mode="edge")
        dist = batched_sssp(ell_src, ell_w,
                            torch.as_tensor(pad, device=dev),
                            layout=ell_layout(ell_src, ell_w, batch=width))
        for r, row in zip(part, dist.cpu().numpy()):
            planes[int(r)] = row
    return planes


def _on_tied_path(du: np.ndarray, dv: np.ndarray,
                  w: float) -> np.ndarray:
    """Boolean [n] mask of roots h for which edge (u, v) of weight w
    lies on a shortest-or-tied path from h, given the endpoint planes
    du = d(., u), dv = d(., v). Finite guards keep inf + w <= inf
    (both endpoints unreachable) from reading as affected."""
    w = np.float32(w)
    return ((np.isfinite(du) & (du + w <= dv))
            | (np.isfinite(dv) & (dv + w <= du)))


def affected_hubs(g_old: Graph, g_new: Graph, rb: ResolvedBatch, *,
                  chunk: int = DEFAULT_CHUNK,
                  device: DeviceLike = None) -> np.ndarray:
    """Sorted unique vertex ids whose trees a repair must re-plant.

    Every id is a *candidate* hub: the repair pass re-plants these
    trees whether or not they emitted labels before, because an
    unaffected-but-covered vertex can gain labels from an affected
    hub's tree (and vice versa): the per-tree test is on roots, not
    on label rows.
    """
    if len(rb) == 0:
        return np.zeros(0, dtype=np.int64)
    old_side = np.isin(rb.kind, (DELETE, REWEIGHT))
    new_side = np.isin(rb.kind, (INSERT, REWEIGHT))
    old_ep = np.unique(np.concatenate([rb.u[old_side], rb.v[old_side]]))
    new_ep = np.unique(np.concatenate([rb.u[new_side], rb.v[new_side]]))
    old_planes = endpoint_planes(g_old, old_ep, chunk=chunk, device=device)
    new_planes = endpoint_planes(g_new, new_ep, chunk=chunk, device=device)

    hit = np.zeros(g_old.n, dtype=bool)
    for i in range(len(rb)):
        u, v = int(rb.u[i]), int(rb.v[i])
        if old_side[i]:
            hit |= _on_tied_path(old_planes[u], old_planes[v],
                                 rb.w_old[i])
        if new_side[i]:
            hit |= _on_tied_path(new_planes[u], new_planes[v],
                                 rb.w_new[i])
    return np.flatnonzero(hit).astype(np.int64)
