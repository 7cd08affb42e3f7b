"""PLaNT — Prune Labels And (do) Not (prune) Trees (paper §5.2).

Unpruned shortest-path trees carry the max-rank ancestor along every
shortest path (the ``mrank`` plane of the batched relaxation), and a
label ``(root, v)`` is canonical iff ``mrank[v] == R(root)`` — a local
criterion with no dependence on other trees' labels. Optional
common-label pruning (§5.3) blocks propagation out of vertices already
covered by a top-η hub and masks emission at covered vertices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core import labels as lbl
from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike
from repro_torch.sssp import relax


class TreeBatch(NamedTuple):
    """Result of one batch of PLaNTed trees."""
    emit: torch.Tensor       # bool [B, n] — label (root_b, v) is canonical
    dist: torch.Tensor       # f32  [B, n]
    explored: torch.Tensor   # i32  [B] — vertices reached per tree
    sweeps: int              # relaxation sweeps to fixpoint


def hc_block_fn(hc: LabelTable, roots: torch.Tensor):
    """HC pruning's block function for a batch of ``roots`` (§5.3): True
    at ``[b, v]`` where the Common Label Table ``hc`` already covers the
    tentative distance, so v neither propagates nor emits in tree b."""
    cover = lbl.cover_distance(hc, lbl.hub_distance_map(hc, roots))

    def block_fn(dist: torch.Tensor, roots_: torch.Tensor) -> torch.Tensor:
        return cover <= dist
    return block_fn


def plant_batch(ell_src: torch.Tensor, ell_w: torch.Tensor,
                rank: torch.Tensor, roots: torch.Tensor,
                valid: torch.Tensor, hc: Optional[LabelTable] = None,
                use_hc: bool = False, layout=None) -> TreeBatch:
    """PLaNT a batch of trees rooted at ``roots`` (padding masked by
    ``valid``). ``hc``/``use_hc``: the Common Label Table of §5.3 (the
    top-η hubs' labels) as a distance-query pruning oracle: a vertex
    whose tentative distance the table already covers neither
    propagates nor emits. ``layout``: optional source-bucketed layout
    (`repro_torch.sssp.relax.ell_layout`), built once per graph by the
    caller; required, built with ``tail=``, where the adjacency has a
    hub tail (the sweeps read the ELL alone without one)."""
    block_fn = None
    if use_hc:
        if hc is None:
            raise ValueError("use_hc=True needs the common label table hc")
        block_fn = hc_block_fn(hc, roots)
    dev = ell_src.device
    with tracing.span("plant.relax", dev):
        st = relax.batched_sssp_maxrank(ell_src, ell_w, rank, roots,
                                        block_fn=block_fn, layout=layout)
    with tracing.span("plant.emit", dev):
        root_rank = rank[roots.long()][:, None]
        emit = (st.mrank == root_rank) & torch.isfinite(st.dist)
        if use_hc:
            emit &= ~block_fn(st.dist, roots)
        emit &= valid[:, None]
    return TreeBatch(emit=emit, dist=st.dist, explored=st.explored,
                     sweeps=st.sweeps)


def plant_chl(g, rank: np.ndarray, *, batch: int = 16,
              cap: Optional[int] = None, hc: Optional[LabelTable] = None,
              roots_order: Optional[np.ndarray] = None, ckpt=None,
              resume: bool = False, device: DeviceLike = None
              ) -> Tuple[LabelTable, dict]:
    """Full CHL construction with pure PLaNT on ``device`` (default: the
    card): a thin wrapper over `repro_torch.engine.run_build`. ``hc``
    prunes every tree with a common label table on the build's device.
    Returns the label table and the per-batch stats lists."""
    from repro_torch.engine import run_build
    res = run_build(g, rank, algo="plant", batch=batch, cap=cap, hc=hc,
                    roots_order=roots_order, ckpt=ckpt, resume=resume,
                    device=device)
    stats = {"explored": [r.explored for r in res.records],
             "labels": [r.labels for r in res.records],
             "sweeps": [r.sweeps for r in res.records],
             "psi": [r.psi for r in res.records]}
    return res.sink.table(), stats
