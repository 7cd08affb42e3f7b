"""The three collectives the distributed builds and the query modes
use, over a list of per-node tensors (node ``i``'s on its mesh device):

- `all_gather`: every node's tensor stacked on a new leading node axis;
- `pmax` / `pmin`: the elementwise max / min over the nodes.

Each returns one result per node, on that node's device (nodes that
share a device share the result, which callers must not modify). They
are exact: a concatenation, or a max or min of integers and integral
f32. No other module of the port does arithmetic across nodes.

Each call adds one to its function's entry of `COUNTS` and the bytes a
direct exchange moves between distinct nodes (each node's piece to the
q - 1 others) to `BYTES`: a PLaNT superstep makes no call, a DGLL
superstep at least one, and the tests and the card check read these.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

COUNTS: Dict[str, int] = {"all_gather": 0, "pmax": 0, "pmin": 0}
BYTES: Dict[str, int] = {"all_gather": 0, "pmax": 0, "pmin": 0}


def reset_counts() -> None:
    for d in (COUNTS, BYTES):
        for k in d:
            d[k] = 0


def total_calls() -> int:
    return sum(COUNTS.values())


def _note(name: str, xs: Sequence[torch.Tensor]) -> None:
    COUNTS[name] += 1
    BYTES[name] += (len(xs) - 1) * sum(x.numel() * x.element_size()
                                       for x in xs)


def _to_each(x: torch.Tensor, like: Sequence[torch.Tensor]
             ) -> List[torch.Tensor]:
    """``x`` on every node's device, one copy per distinct device."""
    out: Dict[torch.device, torch.Tensor] = {}
    for t in like:
        if t.device not in out:
            out[t.device] = x.to(t.device)
    return [out[t.device] for t in like]


def all_gather(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``[q, *shape]``: the nodes' tensors stacked in node order, on
    every node's device."""
    _note("all_gather", xs)
    home = xs[0].device
    return _to_each(torch.stack([x.to(home) for x in xs]), xs)


def _reduce(name: str, xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    _note(name, xs)
    home = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, x.to(home))
    return _to_each(acc, xs)


def pmax(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise max over the nodes, on every node's device."""
    return _reduce("pmax", xs, torch.maximum)


def pmin(xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Elementwise min over the nodes, on every node's device."""
    return _reduce("pmin", xs, torch.minimum)
