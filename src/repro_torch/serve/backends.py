"""Storage-mode wiring for PPSD query serving (QLSN / QFDL / QDOL).

Turns a label store into an ``answer(u, v) -> dist`` callable for one
of the paper's §6.3 storage modes (`repro_torch.core.query`):

- a :class:`DenseStore` (or a bare ``LabelTable``, wrapped dense):
  - *qlsn*: one launch of the ``label_query`` kernel, which reads the
    label rows from the table;
  - *qfdl*: the hub-partitioned per-node tables on a node mesh, each
    node's partial min and one `pmin`. Without a construction-time
    partition of the mesh's size, one is synthesized by round-robin hub
    ownership (§5.1: ``owner(h) = order_index(h) mod q``);
  - *qdol*: ζ-partition overlapping per-node stores, built here;
- a :class:`ShardedStore` answers from its own hub partitions: by
  default routed (`repro_torch.serve.routing`: each shard only over the
  queries whose endpoints both hold labels in it), or with
  ``routed=False`` the stacked reduction (K launches and one
  cross-shard minimum). *qfdl* on a mesh whose size equals the shard
  count places shard k on node k and runs `qfdl_fn` (shard-native);
  otherwise it is the stacked reduction. *qdol* merges the shards once;
- a :class:`SpillStore` gathers the touched rows from its memory-mapped
  shard files on the host and intersects them on its device (routed by
  default when it has several shards). The distributed modes need
  labels in device memory; asking for them raises with guidance;
- a :class:`CompressedStore` gathers and decodes the touched rows of
  its encoded shards on the device, then intersects them (routed by
  default when it has several shards); *qfdl*/*qdol* decode into a
  dense table once.

Every answer equals the dense answer bit for bit (in a compressed
store's exact mode). The mesh of the distributed modes defaults to one
node per device of the store's device type.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.core import query as qm
from repro_torch.core.labels import LabelTable
from repro_torch.index.store import (CompressedStore, DenseStore,
                                     ShardedStore, SpillStore)
from repro_torch.parallel.mesh import make_node_mesh
from repro_torch.parallel.sharding import hub_partition_arrays

MODES = ("qlsn", "qfdl", "qdol")

AnswerFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def partition_by_hub(table: LabelTable, rank: np.ndarray,
                     mesh) -> List[LabelTable]:
    """Synthesize QFDL's per-node partitions from a merged table: node
    ``i`` keeps exactly the labels whose hub it would have generated
    (rank-order round-robin, §5.1), in its own ``[n, L]`` table."""
    L = table.cap
    hubs, dist, count = hub_partition_arrays(
        table.hubs.cpu().numpy(), table.dist.cpu().numpy(), rank, mesh.q,
        shard_cap=L)
    return [LabelTable(torch.as_tensor(hubs[i], device=d),
                       torch.as_tensor(dist[i], device=d),
                       torch.as_tensor(count[i], device=d))
            for i, d in enumerate(mesh.devices)]


def _dense_answer_fn(table: LabelTable, mode: str, *, mesh,
                     partitioned: Optional[List[LabelTable]],
                     rank: Optional[np.ndarray]) -> AnswerFn:
    if mode == "qlsn":
        return lambda u, v: qm.qlsn(table, u, v)
    if mesh is None:
        mesh = make_node_mesh(device=table.hubs.device)
    if mode == "qfdl":
        if partitioned is not None and len(partitioned) == mesh.q:
            partitioned = [LabelTable(*(x.to(d) for x in t))
                           for t, d in zip(partitioned, mesh.devices)]
        else:
            # no construction-time partition of this mesh's size
            if rank is None:
                raise ValueError(
                    "qfdl needs `partitioned` or `rank` to lay out the "
                    "hub partitions")
            partitioned = partition_by_hub(table, rank, mesh)
        f = qm.qfdl_fn(mesh)
        return lambda u, v: f(partitioned, u, v)
    layout = qm.qdol_layout(table.n, mesh.q)
    store = qm.qdol_build(table, layout, mesh)
    f = qm.qdol_fn(mesh, layout)
    return lambda u, v: f(store, u, v)


def make_answer_fn(store, mode: str = "qlsn", *, mesh=None,
                   partitioned: Optional[List[LabelTable]] = None,
                   rank: Optional[np.ndarray] = None,
                   routed: Optional[bool] = None) -> AnswerFn:
    """Answer callable for a storage mode: ``(u, v) -> dist f32 [Q]`` on
    the store's device (node 0's for the distributed modes). ``mesh``
    (a `NodeMesh`) hosts QFDL/QDOL; ``partitioned`` is the build's
    per-node hub partition, synthesized from ``rank`` when absent.
    ``routed`` turns per-shard routing of QLSN on or off; ``None``
    routes a multi-shard sharded, spill or compressed store, and a
    single-shard store never routes."""
    if mode not in MODES:
        raise ValueError(f"unknown query mode {mode!r}; one of {MODES}")
    if isinstance(store, LabelTable):
        store = DenseStore(store)
    if isinstance(store, SpillStore) and mode != "qlsn":
        raise NotImplementedError(
            f"mode {mode!r} needs labels in device memory; a spill "
            "store serves qlsn only — reload with store='dense' or "
            "'sharded' for the distributed modes")
    routable = store.num_shards > 1 and mode == "qlsn"
    if routable if routed is None else (routed and routable):
        from repro_torch.serve.routing import make_routed_answer_fn
        return make_routed_answer_fn(store)
    if mode == "qlsn":
        return lambda u, v: store.query_device(u, v)[0]
    if isinstance(store, ShardedStore):
        if mode == "qfdl":
            if mesh is not None and mesh.q == store.num_shards:
                # shard-native: shard k on node k, partial min + pmin
                part = store.as_partitioned(mesh)
                f = qm.qfdl_fn(mesh)
                return lambda u, v: f(part, u, v)
            # the same partial mins + cross-shard reduction, on the
            # store's device
            return lambda u, v: store.query_device(u, v)[0]
    # qdol (any store) and qfdl (dense, compressed) want dense f32 rows
    return _dense_answer_fn(store.to_table(), mode, mesh=mesh,
                            partitioned=partitioned, rank=rank)
