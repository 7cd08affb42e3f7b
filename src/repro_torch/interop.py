"""Carry state across from host numpy arrays into port objects.

The reference package hands out numpy arrays (its `Graph` fields, a
label table's ``hubs``/``dist``/``count`` once fetched, a rank, a
store's per-shard arrays, an LM's weights and training state); these
helpers turn them into the port's objects on a given device, and
`lm_tree` turns the port's LM leaves back into the reference's layout.
The artifact and checkpoint loaders and the cross-package tests go
through here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.labels import LabelTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.graphs.graph import Graph, cap_ell


def graph(source) -> Graph:
    """A port `Graph` from any object carrying the same fields (host
    numpy arrays). A source without a tail, e.g. the reference package's
    graph, whose ELL is padded to its largest in-degree, is capped as
    `graphs.from_edges` caps it (`graphs.cap_ell`)."""
    if hasattr(source, "tail_dst"):
        return Graph(**{f.name: getattr(source, f.name)
                        for f in dataclasses.fields(Graph)})
    ell_src, ell_w, (t_dst, t_src, t_w) = cap_ell(source.ell_src,
                                                  source.ell_w)
    return Graph(n=source.n, m=source.m, directed=source.directed,
                 ell_src=ell_src, ell_w=ell_w, tail_dst=t_dst,
                 tail_src=t_src, tail_w=t_w, indptr=source.indptr,
                 indices=source.indices, weights=source.weights)


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


def _ref_path(name: str):
    """The reference's leaf path of port parameter ``name`` and its
    group: stack leaf ``<stack>.groups.{g}.blk{j}.<path>`` is the
    reference's ``<stack>/blk{j}/<path>[g]``; any other leaf keeps its
    path (group ``None``)."""
    parts = name.split(".")
    if len(parts) > 2 and parts[1] == "groups":
        return "/".join([parts[0]] + parts[3:]), int(parts[2])
    return "/".join(parts), None


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _host(x):
    """A leaf as something ``torch.as_tensor`` takes: tensors pass,
    numpy-like arrays (a JAX array too) become numpy, bf16 widened to
    its exact f32."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _ref_leaves(cfg, tree):
    """``(port name, meta parameter, reference leaf slice)`` for every
    parameter of the port's `LM` for ``cfg``, from ``tree`` in the
    reference's layout. Raises unless the two sets of leaves and their
    shapes match."""
    from repro_torch.models.model import abstract_params
    ref = dict(_flat(tree))
    used = set()
    for name, p in abstract_params(cfg).named_parameters():
        path, g = _ref_path(name)
        if path not in ref:
            raise ValueError(f"{name}: no reference leaf {path}")
        arr = _host(ref[path])
        if g is not None:
            arr = arr[g]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference leaf {path} has "
                             f"shape {tuple(arr.shape)}, not "
                             f"{tuple(p.shape)}")
        used.add(path)
        yield name, p, arr
    if used != set(ref):
        raise ValueError(f"reference leaves not in the port's model: "
                         f"{sorted(set(ref) - used)}")


def _tensor(arr, dtype, device) -> torch.Tensor:
    """An owned tensor of ``dtype`` on ``device`` from a leaf slice."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=dtype, copy=True)
    return torch.as_tensor(np.array(arr), dtype=dtype, device=device)


def lm_params(cfg, params, device: DeviceLike = None):
    """The port's `LM` for ``cfg`` on ``device`` (default: the card)
    holding exactly the reference's weights ``params``: its nested dict
    of host arrays (``embed/...``, ``dec/blk{j}/...``, and ``enc/...``,
    ``enc_ln``, ``final_ln``), each stack leaf stacked ``[G, ...]`` on
    a leading group axis (`_ref_path` maps the names). Raises unless
    the two sets of leaves and their shapes match."""
    from repro_torch.models.model import abstract_params
    dev = resolve_device(device)
    model = abstract_params(cfg).to_empty(device=dev)
    own = dict(model.named_parameters())
    with torch.no_grad():
        for name, _, arr in _ref_leaves(cfg, params):
            own[name].copy_(_tensor(arr, own[name].dtype, dev))
    return model


def _named_leaves(cfg, tree, dtype=None, device: DeviceLike = None):
    """``{port parameter name: tensor}`` on ``device`` (default: the
    card) from a tree in the reference's layout, e.g. AdamW's moments;
    ``dtype`` (default: each parameter's) is the tensors' dtype."""
    dev = resolve_device(device)
    return {name: _tensor(arr, dtype or p.dtype, dev)
            for name, p, arr in _ref_leaves(cfg, tree)}


def lm_tree(named):
    """The inverse of `lm_params`' mapping: ``{port name: tensor}`` (a
    model's parameters, their grads, AdamW's moments) as a nested dict
    in the reference's layout, each stack leaf stacked ``[G, ...]``
    (`torch.stack`, on the tensors' device)."""
    by_path = {}
    for name, t in named.items():
        path, g = _ref_path(name)
        by_path.setdefault(path, []).append((g, t))
    tree = {}
    for path, items in by_path.items():
        if items[0][0] is None:
            leaf = items[0][1]
        else:
            leaf = torch.stack([t for _, t in
                                sorted(items, key=lambda it: it[0])])
        leaf = leaf.detach()
        node = tree
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = leaf
    return tree


def train_state(cfg, ocfg, ref_state, device: DeviceLike = None):
    """The port's `TrainState` on ``device`` (default: the card) from a
    training state in the reference's layout: ``ref_state.params`` (the
    nested dict `lm_params` takes) and ``ref_state.opt`` with ``step``,
    ``mu``, ``nu`` and ``master`` (``None`` without master copies),
    numpy, JAX arrays or tensors (a restored checkpoint). The moments
    take ``ocfg.state_dtype``, the master copies f32."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.trainer import TrainState
    dev = resolve_device(device)
    model = lm_params(cfg, ref_state.params, dev)
    opt = ref_state.opt
    master = None
    if opt.master is not None:
        master = _named_leaves(cfg, opt.master, torch.float32, dev)
    step = _tensor(_host(opt.step), torch.int32, dev).reshape(())
    return TrainState(params=model, opt=OptState(
        step=step,
        mu=_named_leaves(cfg, opt.mu, ocfg.state_dtype, dev),
        nu=_named_leaves(cfg, opt.nu, ocfg.state_dtype, dev),
        master=master))
