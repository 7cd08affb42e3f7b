"""Carry state across from host numpy arrays into port objects.

The reference package hands out numpy arrays (its `Graph` fields, a
label table's ``hubs``/``dist``/``count`` once fetched, a rank); these
helpers turn them into the port's objects on a given device. The
artifact loader and the cross-package tests both go through here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import Graph


def graph(source) -> Graph:
    """A port `Graph` from any object carrying the same fields (host
    numpy arrays), e.g. the reference package's graph."""
    return Graph(**{f.name: getattr(source, f.name)
                    for f in dataclasses.fields(Graph)})


def label_table(hubs, dist, count, device: DeviceLike = None) -> LabelTable:
    """A `LabelTable` on ``device`` from host hubs i32 [n, L], dist f32
    [n, L] and count i32 [n] (default device: the card)."""
    dev = resolve_device(device)
    return LabelTable(
        hubs=torch.as_tensor(np.asarray(hubs, np.int32), device=dev),
        dist=torch.as_tensor(np.asarray(dist, np.float32), device=dev),
        count=torch.as_tensor(np.asarray(count, np.int32), device=dev))


def rank_tensor(rank, device: DeviceLike = None) -> torch.Tensor:
    """A rank vector as an int32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(rank).astype(np.int32),
                           device=resolve_device(device))
