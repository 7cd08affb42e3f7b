"""Storage-mode wiring for PPSD query serving.

Turns a label store into an ``answer(u, v) -> dist`` callable for one
of the paper's §6.3 storage modes. This slice serves QLSN (every node
holds all labels; the querying node intersects locally) over a
:class:`DenseStore`: on the card the answer is one launch of the
`label_query` kernel, which reads the label rows from the table. QFDL,
QDOL and the other stores are still to port.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.index.store import DenseStore

MODES = ("qlsn", "qfdl", "qdol")

AnswerFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_answer_fn(store, mode: str = "qlsn") -> AnswerFn:
    """Answer callable for a storage mode: ``(u, v) -> dist f32 [Q]``
    on the store's device."""
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}; one of {MODES}")
    if mode != "qlsn":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1, item 11)")
    if not isinstance(store, DenseStore):
        raise NotImplementedError(
            f"serving a {type(store).__name__} is not ported yet "
            "(ROADMAP Queue 1, item 9)")
    return lambda u, v: store.query_device(u, v)[0]
