"""Directed-graph hub labeling (paper footnote 1: forward and backward
labels). A digraph query u->v intersects ``L_out[u]`` with ``L_in[v]``.

PLaNTing a tree from ``h`` forward (pull over the in-edges of G) gives
``d(h->v)`` and fills ``L_in``; a tree on the reversed graph gives
``d(v->h)`` and fills ``L_out``. PLaNT's max-rank criterion holds per
direction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike
from repro_torch.kernels.label_query import query_table_pair


def plant_directed_chl(g, rank: np.ndarray, *, batch: int = 16,
                       cap: Optional[int] = None,
                       device: DeviceLike = None, ckpt=None,
                       resume: bool = False) -> Tuple[LabelTable, LabelTable]:
    """``(L_out, L_in)`` of a directed graph on ``device`` (default: the
    card): a thin wrapper over ``run_build(algo="directed")``, which
    also checkpoints and resumes through ``ckpt``."""
    from repro_torch.engine import run_build
    if not g.directed:
        raise ValueError("plant_directed_chl needs a directed graph")
    res = run_build(g, rank, algo="directed", batch=batch, cap=cap,
                    device=device, ckpt=ckpt, resume=resume)
    return res.sink.table("out"), res.sink.table("in")


def query_directed(l_out: LabelTable, l_in: LabelTable, u, v, *,
                   with_hub: bool = False):
    """min over common hubs x of d(u->x) + d(x->v), for index tensors
    ``u``, ``v`` on the tables' device (int64 on the card). With
    ``with_hub=True`` also the witnessing hub (-1 when the label sets are
    disjoint). On CUDA tables this is one launch of the hand-written
    ``label_query`` kernel over the two tables."""
    best, hub = query_table_pair(l_out, l_in, u, v)
    return (best, hub) if with_hub else best
