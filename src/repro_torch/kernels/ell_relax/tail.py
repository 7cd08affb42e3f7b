"""The hub tail of a degree-capped pull ELL.

`repro_torch.graphs.graph` caps the pull ELL at ``ELL_CAP`` columns: a
vertex's in-edges past the cap go, in column order, to a tail of arcs
sorted by destination (`EllTail`). `graphs.device_adjacency` returns it
beside the two ELL tensors and `graphs.DeviceGraph.tail` carries it.

A tailed adjacency is always swept through its source-windowed layout,
on every device: its owner passes the tail to `layout.sweep_layout`
(``tail=``), which folds it into the layout's segments, and hands that
layout to the sweep. The dense kernel and the plain dense sweep read
the ELL alone; ``ref.ell_sweep_ref`` and ``ref.ell_sweep_plain`` take a
tail only as oracles, to hold the layout's route against ELL + tail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EllTail(NamedTuple):
    """The in-edges past the ELL's cap, one entry an arc."""
    dst: torch.Tensor     # i32 [T] destination (the ELL row), ascending
    src: torch.Tensor     # i32 [T] source
    w: torch.Tensor       # f32 [T] weight, finite
