"""The hub tail of a degree-capped pull ELL.

`repro_torch.graphs.graph` caps the pull ELL at ``ELL_CAP`` columns: a
vertex's in-edges past the cap go, in column order, to a tail of arcs
sorted by destination (`EllTail`). The sweep's entry points take an
adjacency as the pair ``(ell_src, ell_w)``, so the tail travels with
that pair: `attach` binds it to the two tensors and `tail_of` finds it
again by their identity, as `layout.sweep_layout` finds a layout and
`repro_torch.tracing` a degree count. A copy or a view of the ELL
tensors carries no tail; `graphs.device_adjacency` makes tensors that
do.

Every route reads the tail: the source-windowed layout folds it into
its segments, the plain version folds it beside the ELL. The dense
kernel reads the ELL alone, so it refuses a tailed adjacency
(`refuse_tail`), and on the card a tailed adjacency always takes the
windowed route.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch
from torch.utils.weak import WeakIdKeyDictionary


class EllTail(NamedTuple):
    """The in-edges past the ELL's cap, one entry an arc."""
    dst: torch.Tensor     # i32 [T] destination (the ELL row), ascending
    src: torch.Tensor     # i32 [T] source
    w: torch.Tensor       # f32 [T] weight, finite


#: ell_src tensor -> (weakref to its ell_w, EllTail); an entry goes with
#: its ell_src tensor
_TAILS = WeakIdKeyDictionary()


def attach(ell_src: torch.Tensor, ell_w: torch.Tensor,
           tail: EllTail) -> None:
    """Bind ``tail`` to the adjacency ``(ell_src, ell_w)``."""
    if not (tail.dst.device == tail.src.device == tail.w.device
            == ell_src.device):
        raise ValueError("attach: the tail lies on another device than "
                         "the ELL")
    _TAILS[ell_src] = (weakref.ref(ell_w), tail)


def tail_of(ell_src: torch.Tensor, ell_w: torch.Tensor
            ) -> Optional[EllTail]:
    """The tail bound to ``(ell_src, ell_w)``, or None. Raises where
    ``ell_src`` carries a tail but ``ell_w`` is not the weight matrix
    bound with it."""
    hit = _TAILS.get(ell_src)
    if hit is None:
        return None
    ref_w, tail = hit
    if ref_w() is not ell_w:
        raise ValueError("ell_src carries a hub tail bound with another "
                         "ell_w: pass the adjacency's own weights")
    return tail


def refuse_tail(name: str, ell_src: torch.Tensor,
                ell_w: torch.Tensor) -> None:
    """Raise where ``(ell_src, ell_w)`` has a tail, for an entry point
    ``name`` that reads the ELL alone."""
    tail = tail_of(ell_src, ell_w)
    if tail is not None:
        raise ValueError(
            f"{name}: this adjacency is degree-capped and {tail.dst.numel()}"
            f" of its arcs lie in a hub tail that {name} does not read; "
            "relax it through ell_sweep (the windowed route or the plain "
            "version)")
