"""Running the LM zoo's plain PyTorch code on DTensors.

`sharded_ops()` is the context a sharded step runs in:

- ``implicit_replication()``: a plain tensor made inside the step (an
  ``arange``, a zero) acts as replicated on the mesh;
- `ReplicateFallback`: DTensor's sharding propagation has no answer for
  some ops of the zoo, or gives an answer a later op cannot take. For an
  op on DTensors it re-runs the op with the operands' shards on the
  offending mesh dimensions gathered (a real collective, which the
  traced step counts) when

  - propagation fails (``view`` of a dimension split unevenly: 15 query
    heads merged with ``head_dim`` on a 16-way axis, say);
  - the result would carry a ``_StridedShard`` (a merged dimension
    whose inner part is sharded), which later ops of the zoo cannot all
    take, or an operand carries one already;
  - the op is a lookup into a table sharded on the looked-up dimension
    (``embedding`` and ``gather`` on a vocab-sharded table): that
    dimension is gathered first, as DTensor's ``_MaskPartial`` answer
    keeps a mask that fake tensors cannot compare.

  `FALLBACKS` counts the ops it re-ran, by op (`reset_fallbacks`);
- a pointwise sharding rule for ``log_sigmoid_forward`` and
  ``log_sigmoid_backward`` (xLSTM's gates), which DTensor lacks.

`fake_dtensor` and `shard_module_` build fake DTensors of a layout
(nothing allocated) and put them in place of a module's parameters.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Sequence

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map

#: placements that `ReplicateFallback` gathers
_ODD = ("_StridedShard", "_MaskPartial", "MaskPartial")


#: ops `ReplicateFallback` re-ran with gathered operands, by op name
FALLBACKS: Dict[str, int] = {}


def reset_fallbacks() -> None:
    FALLBACKS.clear()


def _odd(p) -> bool:
    return type(p).__name__ in _ODD


def _propagation_failed(e: Exception) -> bool:
    return "Sharding propagation failed" in str(e)


class ReplicateFallback(TorchDispatchMode):
    """See the module docstring. Enter it above every mode that must see
    an op's local tensors (`roofline.analysis.StepCounter`, the
    ``FakeTensorMode``)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        dts = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, DTensor)]
        if not dts:
            return func(*args, **kwargs)
        ndim = dts[0].device_mesh.ndim
        drop = {i for a in dts for i, p in enumerate(a.placements)
                if _odd(p)} | _lookup_dims(func, args)
        while True:
            a2, k2 = (_gather(args, kwargs, drop) if drop
                      else (args, kwargs))
            try:
                out = func(*a2, **k2)
            except RuntimeError as e:
                if not _propagation_failed(e) or len(drop) == ndim:
                    raise
                drop.add(max(set(range(ndim)) - drop))
                continue
            bad = {i for o in tree_leaves(out) if isinstance(o, DTensor)
                   for i, p in enumerate(o.placements) if _odd(p)}
            if bad - drop:
                drop |= bad
                continue
            if drop:
                key = str(func)
                FALLBACKS[key] = FALLBACKS.get(key, 0) + 1
            return out


def _lookup_dims(func, args) -> set:
    """Mesh dimensions on which a lookup's table is sharded along the
    looked-up dimension."""
    aten = torch.ops.aten
    if func is aten.embedding.default:
        table, dim = args[0], 0
    elif func is aten.gather.default:
        table, dim = args[0], args[1] % args[0].ndim
    else:
        return set()
    return {i for i, p in enumerate(getattr(table, "placements", ()))
            if p.is_shard() and p.dim == dim}


def _gather(args, kwargs, drop):
    """``(args, kwargs)`` with every DTensor's placements on the mesh
    dimensions ``drop`` made ``Replicate()``."""
    from torch.distributed.tensor import DTensor, Replicate

    def one(a):
        if not isinstance(a, DTensor):
            return a
        pl = [Replicate() if i in drop and not p.is_replicate() else p
              for i, p in enumerate(a.placements)]
        if pl == list(a.placements):
            return a
        return redistribute(a, pl)

    return tree_map(one, (args, kwargs))


def redistribute(a, placements):
    """``a.redistribute`` to ``placements`` on its mesh, from ``a``
    detached when autograd is off: redistributing a tensor that requires
    grad (a parameter) under ``no_grad`` ends in an in-place ``detach_``,
    which some DTensor versions cannot shard."""
    if a.requires_grad and not torch.is_grad_enabled():
        a = a.detach()
    return a.redistribute(a.device_mesh, placements)


_RULES_DONE = False


def _register_rules() -> None:
    """Pointwise sharding rules for the ops DTensor has none for."""
    global _RULES_DONE
    if _RULES_DONE:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    aten = torch.ops.aten

    def same(ndim, n_in, n_out):
        # every operand and result alike; log_sigmoid's ``buffer`` is
        # empty on CUDA, so it stays as the kernel made it (replicated)
        out = [([Shard(d)] * n_out, [Shard(d)] * n_in)
               for d in range(ndim)]
        return out + [([Replicate()] * n_out, [Replicate()] * n_in)]

    @register_sharding(aten.log_sigmoid_forward.default)
    def _fwd(x):
        return [(list(o) + [Replicate()], i)
                for o, i in same(x.ndim, 1, 1)]

    @register_sharding(aten.log_sigmoid_backward.default)
    def _bwd(grad, x, buffer):
        return [(o, list(i) + [Replicate()])
                for o, i in same(x.ndim, 2, 1)]

    _RULES_DONE = True


@contextlib.contextmanager
def sharded_ops():
    """The context of a sharded step (see the module docstring)."""
    from torch.distributed.tensor.experimental import implicit_replication
    _register_rules()
    with implicit_replication(), ReplicateFallback():
        yield


def fake_dtensor(shape: Sequence[int], dtype, mesh, placements,
                 fake_mode, device=None):
    """A DTensor of global ``shape`` laid out by ``placements`` whose
    local shard is a fake tensor of ``fake_mode`` on ``device`` (default:
    the mesh's device type): shapes only, nothing allocated."""
    from torch.distributed.tensor import DTensor
    local = list(shape)
    for md, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(md)
    dev = device or mesh.device_type
    with fake_mode:
        t = torch.empty(local, dtype=dtype, device=dev)
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def shard_module_(module: nn.Module, make) -> nn.Module:
    """Puts ``make(name, param)`` (a DTensor) in place of every
    parameter of ``module``, in place; returns the module."""
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        mod._parameters[leaf] = nn.Parameter(make(name, p),
                                             requires_grad=p.requires_grad)
    return module
