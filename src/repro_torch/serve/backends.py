"""Storage-mode wiring for PPSD query serving.

Turns a label store into an ``answer(u, v) -> dist`` callable for one
of the paper's §6.3 storage modes. The port serves QLSN (every node
holds all labels; the querying node intersects locally):

- a :class:`DenseStore` answers with one launch of the ``label_query``
  kernel, which reads the label rows from the table;
- a :class:`ShardedStore` answers from its own hub partitions: by
  default routed (`repro_torch.serve.routing`: each shard only over the
  queries whose endpoints both hold labels in it), or with
  ``routed=False`` the stacked reduction (K launches and one
  cross-shard minimum);
- a :class:`SpillStore` gathers the touched rows from its memory-mapped
  shard files on the host and intersects them on its device (routed by
  default when it has several shards, so only the owning shards' files
  are paged in). The distributed modes need labels in device memory;
  asking for them raises with guidance;
- a :class:`CompressedStore` gathers and decodes the touched rows of
  its encoded shards on the device, then intersects them (routed by
  default when it has several shards).

Every answer equals the dense answer bit for bit (in a compressed
store's exact mode). QFDL and QDOL are still to port (ROADMAP Queue 1,
item 11).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.index.store import SpillStore

MODES = ("qlsn", "qfdl", "qdol")

AnswerFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def make_answer_fn(store, mode: str = "qlsn", *,
                   routed: Optional[bool] = None) -> AnswerFn:
    """Answer callable for a storage mode: ``(u, v) -> dist f32 [Q]`` on
    the store's device. ``routed`` turns per-shard routing on or off;
    ``None`` routes a multi-shard sharded, spill or compressed store,
    and a single-shard store never routes."""
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}; one of {MODES}")
    if isinstance(store, SpillStore) and mode != "qlsn":
        raise NotImplementedError(
            f"mode {mode!r} needs labels in device memory; a spill "
            "store serves qlsn only — reload with store='dense' or "
            "'sharded' for the distributed modes")
    if mode != "qlsn":
        raise NotImplementedError(
            f"mode={mode!r} is not ported yet (ROADMAP Queue 1, item 11)")
    routable = store.num_shards > 1       # a dense store has one shard
    if routable if routed is None else (routed and routable):
        from repro_torch.serve.routing import make_routed_answer_fn
        return make_routed_answer_fn(store)
    return lambda u, v: store.query_device(u, v)[0]
