"""Parameter sharding rules of the LM zoo, and hub ownership and the
hub-partitioned label layout (paper §5.1).

**Parameter sharding**: logical axis names to mesh axes. One rule set
serves every architecture because resolution is shape-aware
(`repro_torch.parallel.logical.spec_for`): a mesh axis is dropped for a
dimension it does not divide (15 query heads or 5 KV heads against a
16-way ``model`` axis fall back to replication, and `head_dim_fallback`
routes the TP axis to ``head_dim`` instead). The rule sets are the
reference's, key for key:

- ``TP_RULES``: megatron tensor parallelism on ``model`` only;
- ``FSDP_RULES``: TP plus ZeRO-style sharding of ``d_model`` (and the
  embedding rows) over ``data``, parameters and optimizer state alike;
- ``FSDP_OPT_RULES``: FSDP with the embeddings exempt;
- ``SP_RULES``: FSDP with the sequence sharded over ``data``.

**Label sharding**:

Shard ``k`` of a hub-partitioned store holds, for every vertex, exactly
the labels whose hub it owns: ``owner[h] = order_index(h) mod K``. Every
common hub of a query pair is intersected in exactly one shard, so K
per-shard partial minima reduce to the dense answer.

Host numpy, as in the reference package: the partition runs once per
build or load, and `ShardAccumulator` is the streaming sink's host-side
state (its checkpoint payload is the reference's, key for key).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from repro_torch.parallel.logical import MeshAxes, placements, spec_for

# logical parameter-dimension names -> mesh axes
TP_RULES: Dict[str, MeshAxes] = {
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "experts": "model",
    "experts_r": "model",
    "ssm_i": "model",
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab_act": "model",
    "act_ff": "model",
    "act_heads": "model",
    "act_experts": "model",
}

FSDP_RULES: Dict[str, MeshAxes] = dict(
    TP_RULES,
    d_model="data",          # ZeRO-shard params' d_model rows over data
    embed_d="data",          # (baseline: embeddings FSDP-sharded too)
)

# embeddings exempt from FSDP (a token gather against a row-sharded
# table replicates it on every lookup); vocab stays TP-sharded
FSDP_OPT_RULES: Dict[str, MeshAxes] = dict(FSDP_RULES, embed_d=None)

# long-context cells: also shard the sequence (context/ring style)
SP_RULES: Dict[str, MeshAxes] = dict(
    FSDP_RULES,
    seq="data",
    batch="pod",
)


def head_dim_fallback(rules: Dict[str, MeshAxes]) -> Dict[str, MeshAxes]:
    """When q/kv head counts don't divide the TP axis the resolver drops
    them; this variant re-routes TP to the head_dim dimension."""
    return dict(rules, q_heads=None, kv_heads=None, head_dim="model")


def resolve_params(axes: Mapping[str, Sequence[Optional[str]]], mesh,
                   rules: Dict[str, MeshAxes],
                   shapes: Mapping[str, Sequence[int]]) -> Dict[str, list]:
    """``{parameter name: DTensor placements}`` of a model's parameters
    from their logical ``axes`` (`LM.param_axes`) and ``shapes`` (a
    tensor or a shape a name)."""
    out = {}
    for k, ax in axes.items():
        shape = tuple(getattr(shapes[k], "shape", shapes[k]))
        out[k] = placements(spec_for(ax, rules, mesh, shape), mesh)
    return out


def replicated(mesh) -> list:
    """Placements of a tensor every rank holds whole."""
    return placements((), mesh)


def batch_spec(mesh, rules: Dict[str, MeshAxes], ndim: int, shape=None):
    """The spec of a batch tensor: its leading dimension ``"batch"``,
    the others replicated."""
    return spec_for(["batch"] + [None] * (ndim - 1), rules, mesh, shape)


def batch_sharding(mesh, rules: Dict[str, MeshAxes], ndim: int,
                   shape=None) -> list:
    """Placements of `batch_spec`."""
    return placements(batch_spec(mesh, rules, ndim, shape), mesh)


def hub_owner(rank: np.ndarray, num_shards: int) -> np.ndarray:
    """``owner[h]``: the shard owning hub ``h``, round-robin over the
    rank-descending order (§5.1: R(v) mod K)."""
    order = np.argsort(-np.asarray(rank).astype(np.int64), kind="stable")
    owner = np.empty(len(order), dtype=np.int64)
    owner[order] = np.arange(len(order)) % max(1, num_shards)
    return owner


def hub_partition_arrays(hubs: np.ndarray, dist: np.ndarray,
                         rank: np.ndarray, num_shards: int,
                         shard_cap: Optional[int] = None
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a padded ``[n, L]`` label table into the hub-partitioned
    ``[K, n, Ls]`` layout, each shard's rows compacted left in slot
    order. Returns ``(hubs i32, dist f32 [K, n, Ls], count i32 [K, n])``;
    ``Ls`` defaults to the tightest per-shard row."""
    hubs = np.asarray(hubs)
    dist = np.asarray(dist)
    n, _ = hubs.shape
    K = max(1, num_shards)
    owner = hub_owner(rank, K)
    valid = hubs >= 0
    slot_owner = np.where(valid, owner[np.where(valid, hubs, 0)], -1)
    count = np.stack([(slot_owner == k).sum(axis=1) for k in range(K)])
    Ls = int(max(1, count.max())) if shard_cap is None else int(shard_cap)
    if count.max() > Ls:
        raise ValueError(f"shard_cap={Ls} < max per-shard row "
                         f"{int(count.max())}")
    out_h = np.full((K, n, Ls), -1, dtype=np.int32)
    out_d = np.full((K, n, Ls), np.inf, dtype=np.float32)
    for k in range(K):
        mine = slot_owner == k                     # [n, L]
        dest = np.cumsum(mine, axis=1) - 1         # slot within the row
        rows, cols = np.nonzero(mine)
        out_h[k, rows, dest[rows, cols]] = hubs[rows, cols]
        out_d[k, rows, dest[rows, cols]] = dist[rows, cols]
    return out_h, out_d, count.astype(np.int32)


class ShardAccumulator:
    """Incremental host-side builder of the hub-partitioned layout.

    K per-shard ``[n, cap_k]`` arrays whose capacities regrow
    geometrically and independently, for builds that emit superstep by
    superstep and never hold the dense ``[n, cap]`` table (the engine's
    `StreamingShardSink`). A shard row fills in emission order, which is
    the slot order a dense build re-homed by `hub_partition_arrays`
    gives, so the two paths are bit-identical.
    """

    def __init__(self, n: int, rank: np.ndarray, num_shards: int,
                 init_cap: int = 8):
        self.n = int(n)
        self.num_shards = max(1, int(num_shards))
        self.owner = hub_owner(rank, self.num_shards)
        cap0 = max(1, int(init_cap))
        self.hubs = [np.full((self.n, cap0), -1, dtype=np.int32)
                     for _ in range(self.num_shards)]
        self.dist = [np.full((self.n, cap0), np.inf, dtype=np.float32)
                     for _ in range(self.num_shards)]
        self.count = np.zeros((self.num_shards, self.n), dtype=np.int32)

    def _grow(self, k: int, need: int) -> None:
        cap = self.hubs[k].shape[1]
        new = cap
        while new < need:
            new *= 2
        if new == cap:
            return
        self.hubs[k] = np.pad(self.hubs[k], ((0, 0), (0, new - cap)),
                              constant_values=-1)
        self.dist[k] = np.pad(self.dist[k], ((0, 0), (0, new - cap)),
                              constant_values=np.inf)

    def insert(self, roots: np.ndarray, valid: np.ndarray,
               emit: np.ndarray, dist: np.ndarray) -> int:
        """Append ``(roots[b], dist[b, v])`` for every ``emit[b, v]`` of
        a valid tree into the root's shard (all of a tree's labels share
        its hub: one shard a tree); returns the labels added."""
        roots = np.asarray(roots)
        valid = np.asarray(valid)
        emit = np.asarray(emit)
        dist = np.asarray(dist)
        added = 0
        for b in range(len(roots)):
            if not valid[b]:
                continue
            r = int(roots[b])
            vs = np.nonzero(emit[b])[0]
            if not len(vs):
                continue
            k = int(self.owner[r])
            pos = self.count[k, vs]
            self._grow(k, int(pos.max()) + 1)
            self.hubs[k][vs, pos] = r
            self.dist[k][vs, pos] = dist[b, vs]
            self.count[k, vs] += 1
            added += len(vs)
        return added

    @property
    def total_labels(self) -> int:
        return int(self.count.sum())

    def shard_arrays(self):
        """Per-shard ``{hubs, dist, count}``, each trimmed to its own
        tight cap (as `ShardedStore.shard_arrays` yields them)."""
        for k in range(self.num_shards):
            cap = int(max(1, self.count[k].max()))
            yield k, {"hubs": self.hubs[k][:, :cap],
                      "dist": self.dist[k][:, :cap],
                      "count": self.count[k]}

    # --------------------------------------------- checkpoint payload

    def state_arrays(self) -> Dict[str, np.ndarray]:
        """Copies, not views: inserts write the live buffers in place,
        and a checkpoint must hold this superstep's state."""
        out: Dict[str, np.ndarray] = {"count": self.count.copy()}
        for k in range(self.num_shards):
            out[f"shard{k}_hubs"] = self.hubs[k].copy()
            out[f"shard{k}_dist"] = self.dist[k].copy()
        return out

    def load_state(self, arrays) -> None:
        self.count = np.asarray(arrays["count"]).astype(np.int32).copy()
        self.hubs = [np.asarray(arrays[f"shard{k}_hubs"]).copy()
                     for k in range(self.num_shards)]
        self.dist = [np.asarray(arrays[f"shard{k}_dist"]).copy()
                     for k in range(self.num_shards)]
