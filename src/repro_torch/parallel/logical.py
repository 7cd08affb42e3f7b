"""Logical-axis sharding context (MaxText-style logical axes) over a
PyTorch ``DeviceMesh``.

Models annotate activations with *logical* names
(``constrain(x, "batch", "seq", "embed")``); a thread-level context set
by the step factories and the dry-run maps logical names to mesh axes.
Outside a context, or on a plain tensor, the call is the identity, so
the one-card paths need no mesh.

A spec is a tuple with one entry a tensor dimension: ``None``, one mesh
axis name, or a tuple of names (the dimension split over several mesh
axes, the first the outermost). `placements` turns it into DTensor
placements; `spec_for` only reads ``dict(mesh.shape)``, so any object
with a ``shape`` mapping of axis sizes serves it.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

MeshAxes = Union[str, Tuple[str, ...], None]
Spec = Tuple[MeshAxes, ...]

_ctx = threading.local()


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    a ``shape`` mapping, as the reference's meshes have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None and hasattr(mesh, "size"):
        return {a: mesh.size(i) for i, a in enumerate(names)}
    return dict(mesh.shape)


@contextlib.contextmanager
def axis_rules(mesh, rules: Dict[str, MeshAxes]):
    """Activate the logical-to-mesh mapping for `constrain` calls."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, dict(rules))
    try:
        yield
    finally:
        _ctx.state = prev


def current_rules():
    """``(mesh, rules)`` of the innermost `axis_rules`, or ``None``."""
    return getattr(_ctx, "state", None)


def spec_for(names: Sequence[Optional[str]],
             rules: Dict[str, MeshAxes], mesh,
             shape: Optional[Sequence[int]] = None) -> Spec:
    """The spec of logical ``names``, with the divisibility fallback: a
    mesh axis already used by an earlier dimension, or absent from the
    mesh, is dropped; when the dimension's size does not divide the
    product of its axes, the longest prefix of them that divides it is
    kept."""
    used: set = set()
    parts = []
    axis_sizes = mesh_shape(mesh)
    for i, name in enumerate(names):
        ax = rules.get(name) if name else None
        if ax is None:
            parts.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes
                     if a not in used and a in axis_sizes)
        if not axes:
            parts.append(None)
            continue
        size = None if shape is None else shape[i]
        total = 1
        for a in axes:
            total *= axis_sizes[a]
        if size is not None and size % total != 0:
            # try progressively smaller prefixes
            ok: Tuple[str, ...] = ()
            tot = 1
            for a in axes:
                if size % (tot * axis_sizes[a]) == 0:
                    ok = ok + (a,)
                    tot *= axis_sizes[a]
                else:
                    break
            axes = ok
        if not axes:
            parts.append(None)
            continue
        used.update(axes)
        parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on the
    mesh dimension of every axis that dimension ``i`` names (two axes
    on one dimension shard it on both, in mesh order), ``Replicate()``
    on the others."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, ax in enumerate(spec):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            out[names.index(a)] = Shard(i)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (`spec_for` keeps every sharded dimension divisible)."""
    sizes = mesh_shape(mesh)
    out = list(shape)
    for i, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            out[i] //= sizes[a]
    return tuple(out)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` laid out by the spec of ``names`` under the current rules
    (a DTensor is redistributed to it: the counterpart of
    ``with_sharding_constraint``); ``x`` itself outside a context or
    when it is a plain tensor."""
    state = current_rules()
    if state is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = state
    want = placements(spec_for(names, rules, mesh, x.shape), mesh)
    if list(x.placements) == want:
        return x
    from repro_torch.parallel.dtensor import redistribute
    return redistribute(x, want)
