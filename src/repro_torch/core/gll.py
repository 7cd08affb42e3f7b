"""LCC and GLL: optimistic parallel CHL construction plus cleaning (§4).

The paper's ``p`` threads popping rank-ordered roots become a batch of
``B`` trees a step. Trees inside a batch cannot see each other's labels
(the paper's optimistic mistakes), and the interleaved cleaning
(DQ_Clean) removes every redundant label, which yields the CHL.

- LCC: construct everything, clean once at the end (§4.1).
- GLL: clean whenever the local table exceeds ``alpha * n`` labels,
  then commit to the global table (§4.2). Construction-time distance
  queries consult global and local; cleaning probes the superstep's
  own labels.
- paraPLL: no rank queries and no cleaning: covers, but not minimal.

This module keeps the batch steps (`construct_batch`,
`clean_superstep`); the superstep loop (batching, alpha-threshold
flushes, counters) is `repro_torch.engine.GLLPolicy`, and the
``*_chl`` functions are thin wrappers over `run_build`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike
from repro_torch.sssp import relax


class BatchLabels(NamedTuple):
    roots: torch.Tensor   # i32 [B]
    emit: torch.Tensor    # bool [B, n]
    dist: torch.Tensor    # f32 [B, n]


def construct_batch(ell_src: torch.Tensor, ell_w: torch.Tensor,
                    rank: torch.Tensor, roots: torch.Tensor,
                    valid: torch.Tensor, glob: LabelTable, loc: LabelTable,
                    rank_queries: bool = True,
                    layout=None) -> BatchLabels:
    """One batch of pruned trees (the LCC / paraPLL inner step).

    A vertex blocks when the distance query over the global and local
    tables already covers its tentative distance (and, with
    ``rank_queries``, when it outranks the root); a label is emitted
    where a vertex is reached and unblocked at the fixpoint. Roots
    always label themselves; invalid lanes emit nothing. ``layout``:
    the adjacency's source-bucketed layout, built once per graph;
    required, built with ``tail=``, where the adjacency has a hub tail
    (`repro_torch.sssp.relax.ell_layout`).
    """
    cover = torch.minimum(
        lbl.cover_distance(glob, lbl.hub_distance_map(glob, roots)),
        lbl.cover_distance(loc, lbl.hub_distance_map(loc, roots)))  # [B, n]

    def dq_block(dist: torch.Tensor, roots_: torch.Tensor) -> torch.Tensor:
        return cover <= dist

    fns = [dq_block]
    if rank_queries:
        fns.append(relax.rank_block(rank))
    st = relax.batched_sssp_maxrank(ell_src, ell_w, rank, roots,
                                    block_fn=relax.combine_blocks(*fns),
                                    layout=layout)
    roots_l = roots.long()
    emit = torch.isfinite(st.dist) & ~(cover <= st.dist)
    if rank_queries:
        emit &= rank[None, :] <= rank[roots_l][:, None]
    emit[torch.arange(roots.shape[0], device=roots.device), roots_l] = True
    emit &= valid[:, None]
    return BatchLabels(roots=roots, emit=emit, dist=st.dist)


def clean_superstep(glob: LabelTable, loc: LabelTable, rank: torch.Tensor,
                    roots: torch.Tensor, emit: torch.Tensor,
                    dist: torch.Tensor) -> torch.Tensor:
    """DQ_Clean for every label emitted this superstep (``[T, n]``
    stacked emissions, T = the superstep's roots). A label (h -> v, d)
    is redundant iff the best-rank common hub w of L_v and L_h with
    d(v, w) + d(h, w) <= d outranks h. Returns ``redundant [T, n]``."""
    delta = torch.where(emit, dist, -torch.inf)    # never matches when ~emit
    best = torch.maximum(
        lbl.cover_best_rank(glob, lbl.hub_distance_map(glob, roots), rank,
                            delta),
        lbl.cover_best_rank(loc, lbl.hub_distance_map(loc, roots), rank,
                            delta))
    return emit & (best > rank[roots.long()][:, None])


def _legacy_stats(res) -> dict:
    """Engine records -> the GLL counters dict of the ``*_chl`` API."""
    return {"supersteps": len(res.records),
            "cleaned": res.counters.get("cleaned", 0),
            "constructed": res.counters.get("constructed", 0),
            "superstep_sizes": [r.trees for r in res.records]}


def gll_chl(g, rank: np.ndarray, *, batch: int = 8,
            alpha: Optional[float] = 4.0, cap: Optional[int] = None,
            rank_queries: bool = True, clean: bool = True,
            plant_first_superstep: bool = False,
            device: DeviceLike = None) -> Tuple[LabelTable, dict]:
    """GLL (alpha finite), LCC (``alpha=None``: clean once at the end)
    or paraPLL (``rank_queries=False, clean=False``) on ``device``
    (default: the card). Returns (global label table, stats)."""
    from repro_torch.engine import run_build
    res = run_build(g, rank, algo="gll", batch=batch, cap=cap, alpha=alpha,
                    rank_queries=rank_queries, clean=clean,
                    plant_first_superstep=plant_first_superstep,
                    device=device)
    return res.sink.table(), _legacy_stats(res)


def lcc_chl(g, rank: np.ndarray, *, batch: int = 8,
            cap: Optional[int] = None,
            device: DeviceLike = None) -> Tuple[LabelTable, dict]:
    """LCC (§4.1): construct everything, one cleaning pass at the end."""
    from repro_torch.engine import run_build
    res = run_build(g, rank, algo="lcc", batch=batch, cap=cap,
                    device=device)
    return res.sink.table(), _legacy_stats(res)


def parapll_chl(g, rank: np.ndarray, *, batch: int = 8,
                cap: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[LabelTable, dict]:
    """The paraPLL baseline: concurrent pruned trees with no rank
    queries and no cleaning; covers, but redundant labels grow with
    ``batch``."""
    from repro_torch.engine import run_build
    res = run_build(g, rank, algo="parapll", batch=batch, cap=cap,
                    device=device)
    return res.sink.table(), _legacy_stats(res)
