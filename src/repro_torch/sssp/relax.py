"""Batched lexicographic shortest-path relaxation.

A pull-based iterate over the padded ELL adjacency that relaxes a
batch of trees per sweep, to fixpoint. Two planes propagate jointly:

- ``dist[b, v]``  — tentative distance from ``roots[b]`` to ``v``;
- ``mrank[b, v]`` — the maximum rank over the union of all shortest
  ``roots[b] -> v`` paths found so far (endpoints inclusive).

The PLaNT label criterion then reads pointwise: emit ``(root, v)``
iff ``mrank[v] == R(root)``.

Pruning is a blocking mask re-evaluated every sweep: blocked vertices
do not propagate and never emit.

Execution follows the reference driver sweep for sweep, so ``dist``,
``mrank``, ``sweeps`` and ``explored`` are identical to it:

- each sweep runs through `repro_torch.kernels.ell_relax.ell_sweep` —
  the hand-written kernel on CUDA tensors, the plain version on CPU —
  on the route resolved once per call: the source-windowed layout
  given as ``layout=``, or the one the card's L2 calls for (built and
  cached when the source planes outgrow half of it), else the dense
  sweep;
- sweeps are frontier-gated on the kernel path: only vertices whose
  (dist, mrank) changed last sweep, plus vertices that just unblocked,
  propagate; trees whose frontier is empty are retired (``alive``);
  the plain path runs ungated (``frontier_gating`` overrides; the
  fixpoint is the same either way);
- the fixpoint is checked every ``check_every`` sweeps (default
  ``DEFAULT_CHECK_EVERY`` on the kernel path, 1 on the plain path);
  overshoot past the fixpoint is a no-op sweep;
- the loop is a Python loop bounded by ``max_sweeps`` (default n).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.kernels.ell_relax import (BucketedEll, ell_sweep,
                                           resolve_sweep_backend,
                                           sweep_layout)

BlockFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

DEFAULT_CHECK_EVERY = 4


def ell_layout(ell_src: torch.Tensor, ell_w: torch.Tensor, *,
               batch: int) -> Optional[BucketedEll]:
    """Build (and cache) the source-bucketed layout for sweeps of
    ``batch`` trees over this adjacency, or None when one window of the
    card's L2 covers it (and on the CPU) — the driver-facing alias of
    `repro_torch.kernels.ell_relax.sweep_layout`."""
    return sweep_layout(ell_src, ell_w, bb=batch)


class RelaxState(NamedTuple):
    dist: torch.Tensor      # f32 [B, n]
    mrank: torch.Tensor     # i32 [B, n]; -1 where unreached
    sweeps: int             # sweeps executed (counts the overshoot)
    explored: torch.Tensor  # i32 [B] — vertices each tree reached


def _init(n: int, roots: torch.Tensor, rank: torch.Tensor):
    B = roots.shape[0]
    dev = roots.device
    ar = torch.arange(B, device=dev)
    dist = torch.full((B, n), torch.inf, dtype=torch.float32, device=dev)
    dist[ar, roots] = 0.0
    mrank = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    mrank[ar, roots] = rank[roots]
    return dist, mrank


def batched_sssp_maxrank(ell_src: torch.Tensor, ell_w: torch.Tensor,
                         rank: torch.Tensor, roots: torch.Tensor, *,
                         block_fn: Optional[BlockFn] = None,
                         max_sweeps: Optional[int] = None,
                         check_every: Optional[int] = None,
                         frontier_gating: Optional[bool] = None,
                         layout: Optional[BucketedEll] = None
                         ) -> RelaxState:
    """Relax a batch of trees to fixpoint.

    Args:
      ell_src: int32 [n, deg] — in-edge sources (pull layout).
      ell_w:   f32  [n, deg] — in-edge weights, ``inf`` padding.
      rank:    int32 [n] — hierarchy (larger = more important).
      roots:   int64/int32 [B] — tree roots of this batch.
      block_fn: optional per-sweep pruning mask ``(dist, roots) ->
        blocked [B, n]``; roots are force-unblocked.
      max_sweeps: safety bound (default n sweeps, the Bellman-Ford bound).
      check_every: sweeps between fixpoint checks (default: 4 with the
        kernel, 1 on the plain path).
      frontier_gating: mask propagation to the active frontier and
        retire converged trees (default: on with the kernel).
      layout: optional `BucketedEll` (see `ell_layout`) selecting the
        source-windowed sweep; on the card one is built and cached when
        the source planes outgrow one window.
    All tensors lie on one device; CUDA means the kernel runs.
    """
    n = ell_src.shape[0]
    roots = roots.long()
    B = roots.shape[0]
    rank = rank.to(torch.int32)
    cap = n if max_sweeps is None else max_sweeps
    kern = ell_src.device.type == "cuda"
    gated = kern if frontier_gating is None else bool(frontier_gating)
    stride = ((DEFAULT_CHECK_EVERY if kern else 1)
              if check_every is None else check_every)
    stride = max(1, min(stride, cap))
    layout = resolve_sweep_backend(ell_src, ell_w, B, layout=layout)
    dist, mrank = _init(n, roots, rank)
    ar = torch.arange(B, device=roots.device)

    def blocked_of(d):
        # the root of each tree never blocks its own propagation
        return block_fn(d, roots).index_put((ar, roots),
                                            torch.tensor(False,
                                                         device=d.device))

    has_block = block_fn is not None
    all_alive = torch.ones(B, dtype=torch.bool, device=roots.device)
    # first sweep is dense (everything is in the initial frontier);
    # prev_blocked is seeded consistently so no spurious unblocks fire
    frontier = torch.ones((B, n), dtype=torch.bool, device=roots.device)
    prev_blocked = blocked_of(dist) if has_block and gated else None

    def sweep_once(dist, mrank, frontier, prev_blocked):
        blocked = None
        if gated:
            if has_block:
                blocked = blocked_of(dist)
                # frontier ∪ newly-unblocked: a vertex that unblocks
                # without a state change still owes its contribution
                active = frontier | (prev_blocked & ~blocked)
                prop = torch.where(blocked | ~active, torch.inf, dist)
            else:
                active = frontier
                prop = torch.where(active, dist, torch.inf)
            alive = active.any(dim=1)
        else:
            prop = (torch.where(blocked_of(dist), torch.inf, dist)
                    if has_block else dist)
            alive = all_alive
        nd, nm = ell_sweep(dist, mrank, prop, alive, ell_src, ell_w, rank,
                           layout=layout)
        return nd, nm, (nd < dist) | (nm != mrank), blocked

    it = 0
    while it < cap and bool(frontier.any()):
        for _ in range(stride):
            dist, mrank, frontier, prev_blocked = sweep_once(
                dist, mrank, frontier, prev_blocked)
        it += stride
    explored = torch.isfinite(dist).sum(dim=-1).to(torch.int32)
    return RelaxState(dist=dist, mrank=mrank, sweeps=it, explored=explored)


def batched_sssp(ell_src: torch.Tensor, ell_w: torch.Tensor,
                 roots: torch.Tensor, *, max_sweeps: Optional[int] = None,
                 check_every: Optional[int] = None,
                 frontier_gating: Optional[bool] = None,
                 layout: Optional[BucketedEll] = None) -> torch.Tensor:
    """Plain batched SSSP distances f32 [B, n], through the same engine
    with a constant-zero rank plane."""
    n = ell_src.shape[0]
    return batched_sssp_maxrank(
        ell_src, ell_w, torch.zeros(n, dtype=torch.int32,
                                    device=ell_src.device), roots,
        max_sweeps=max_sweeps, check_every=check_every,
        frontier_gating=frontier_gating, layout=layout).dist


def rank_block(rank: torch.Tensor) -> BlockFn:
    """Rank-query pruning mask: block v with ``R(v) > R(root)``."""
    def fn(dist: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
        del dist
        return rank[None, :] > rank[roots][:, None]
    return fn


def combine_blocks(*fns: BlockFn) -> BlockFn:
    def fn(dist: torch.Tensor, roots: torch.Tensor) -> torch.Tensor:
        out = fns[0](dist, roots)
        for f in fns[1:]:
            out = out | f(dist, roots)
        return out
    return fn
