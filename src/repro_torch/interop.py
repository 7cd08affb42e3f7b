"""Carry state across from host numpy arrays into port objects.

The reference package hands out numpy arrays (its `Graph` fields, a
label table's ``hubs``/``dist``/``count`` once fetched, a rank, a
store's per-shard arrays); these helpers turn them into the port's
objects on a given device. The artifact loader and the cross-package
tests both go through here.
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


def _owned(x, dtype) -> np.ndarray:
    """``x`` as a writable array of ``dtype`` that no file backs: a
    memory map or a read-only array is copied, never shared with a
    tensor."""
    a = np.asarray(x, dtype)
    return a if a.flags.writeable and not isinstance(x, np.memmap) \
        else a.copy()


def label_table(hubs, dist, count, device: DeviceLike = None) -> LabelTable:
    """A `LabelTable` on ``device`` from host hubs i32 [n, L], dist f32
    [n, L] and count i32 [n] (default device: the card). Memory-mapped
    or read-only inputs are copied first."""
    dev = resolve_device(device)
    return LabelTable(
        hubs=torch.as_tensor(_owned(hubs, np.int32), device=dev),
        dist=torch.as_tensor(_owned(dist, np.float32), device=dev),
        count=torch.as_tensor(_owned(count, np.int32), device=dev))


def rank_tensor(rank, device: DeviceLike = None) -> torch.Tensor:
    """A rank vector as an int32 tensor on ``device``."""
    return torch.as_tensor(np.asarray(rank).astype(np.int32),
                           device=resolve_device(device))


def compressed_store(source, rank, device: DeviceLike = None):
    """A port `CompressedStore` on ``device`` from any compressed store
    with the reference's accessors: ``shard_arrays()`` yielding the
    encoded ``{dhub, dcode, count}`` host arrays and ``manifest_info()``
    (codec, exactness, scales, max ulp error). The order permutation is
    rebuilt from ``rank``, as a load does; the structural checks of a
    load run too."""
    from repro_torch.index.store import CompressedStore
    shards = [{k: np.asarray(a[k]) for k in ("dhub", "dcode", "count")}
              for _, a in source.shard_arrays()]
    return CompressedStore.from_encoded_shards(
        shards, source.manifest_info(), np.asarray(rank), device=device)


def spill_store(source, device: DeviceLike = None):
    """A port `SpillStore` over the same per-shard ``{hubs, dist,
    count}`` arrays as ``source`` (any store whose ``shard_arrays()``
    yields them, e.g. the reference's spill store: its memory maps are
    shared, not read), intersecting on ``device``."""
    from repro_torch.index.store import SpillStore
    return SpillStore([dict(a) for _, a in source.shard_arrays()],
                      device=device)


def lm_params(cfg, params, device: DeviceLike = None):
    """The port's `LM` for ``cfg`` on ``device`` (default: the card)
    holding exactly the reference's weights ``params``: its nested dict
    of host arrays (``embed/...``, ``dec/blk{j}/...``, and ``enc/...``,
    ``enc_ln``, ``final_ln``), each stack leaf stacked ``[G, ...]`` on
    a leading group axis. Stack leaf ``<stack>/blk{j}/<path>[g]`` is
    the port's ``<stack>.groups.{g}.blk{j}.<path>``; every other leaf
    keeps its path. Raises unless the two sets of leaves and their
    shapes match."""
    from repro_torch.models.model import abstract_params

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, f"{prefix}{k}/")
            else:
                yield f"{prefix}{k}", v

    ref = dict(flat(params))
    dev = resolve_device(device)
    model = abstract_params(cfg).to_empty(device=dev)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            grouped = len(parts) > 2 and parts[1] == "groups"
            path = "/".join([parts[0]] + parts[3:] if grouped else parts)
            if path not in ref:
                raise ValueError(f"{name}: no reference leaf {path}")
            arr = np.asarray(ref[path])
            if grouped:
                arr = arr[int(parts[2])]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference leaf {path} has "
                                 f"shape {arr.shape}, not {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(arr), dtype=p.dtype))
            used.add(path)
    if used != set(ref):
        raise ValueError(f"reference leaves not in the port's model: "
                         f"{sorted(set(ref) - used)}")
    return model
