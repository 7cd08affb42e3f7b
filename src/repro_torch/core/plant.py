"""PLaNT — Prune Labels And (do) Not (prune) Trees (paper §5.2).

Unpruned shortest-path trees carry the max-rank ancestor along every
shortest path (the ``mrank`` plane of the batched relaxation), and a
label ``(root, v)`` is canonical iff ``mrank[v] == R(root)`` — a local
criterion with no dependence on other trees' labels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.sssp import relax


class TreeBatch(NamedTuple):
    """Result of one batch of PLaNTed trees."""
    emit: torch.Tensor       # bool [B, n] — label (root_b, v) is canonical
    dist: torch.Tensor       # f32  [B, n]
    explored: torch.Tensor   # i32  [B] — vertices reached per tree
    sweeps: int              # relaxation sweeps to fixpoint


def plant_batch(ell_src: torch.Tensor, ell_w: torch.Tensor,
                rank: torch.Tensor, roots: torch.Tensor,
                valid: torch.Tensor, hc: Optional[object] = None,
                use_hc: bool = False, layout=None) -> TreeBatch:
    """PLaNT a batch of trees rooted at ``roots`` (padding masked by
    ``valid``). ``layout``: optional source-bucketed layout
    (`repro_torch.sssp.relax.ell_layout`), built once per graph by the
    caller. The common-label-table pruning (``hc``/``use_hc``) belongs
    to the hybrid algorithm and is not ported yet."""
    if use_hc or hc is not None:
        raise NotImplementedError(
            "common-label (hc) pruning belongs to the hybrid slice "
            "(ROADMAP Queue 1, item 11)")
    st = relax.batched_sssp_maxrank(ell_src, ell_w, rank, roots,
                                    layout=layout)
    root_rank = rank[roots.long()][:, None]
    emit = (st.mrank == root_rank) & torch.isfinite(st.dist)
    emit &= valid[:, None]
    return TreeBatch(emit=emit, dist=st.dist, explored=st.explored,
                     sweeps=st.sweeps)
