"""`repro_torch.dynamic` — incremental CHL repair for mutating graphs.

Typed edge mutations (:class:`EdgeInsert` / :class:`EdgeDelete` /
:class:`EdgeReweight` in a :class:`MutationBatch`), affected-tree
frontier seeding (:func:`affected_hubs`), and the engine-driven
:class:`RepairPolicy` that re-plants only invalidated trees, surfaced
as ``CHLIndex.apply(mutations, graph=g) -> RepairReport``,
bit-identical to a from-scratch rebuild on the mutated graph; the
:class:`RepairJournal` makes a repair crash-atomic end to end.
"""

from repro_torch.dynamic.frontier import affected_hubs, endpoint_planes
from repro_torch.dynamic.journal import RepairJournal, store_fingerprint
from repro_torch.dynamic.mutations import (EdgeDelete, EdgeInsert,
                                           EdgeReweight, MutationBatch,
                                           ResolvedBatch, random_mutations)
from repro_torch.dynamic.repair import (RepairPolicy, RepairReport,
                                        repair_index)

__all__ = [
    "EdgeInsert", "EdgeDelete", "EdgeReweight", "MutationBatch",
    "ResolvedBatch", "random_mutations", "affected_hubs",
    "endpoint_planes", "RepairPolicy", "RepairReport", "repair_index",
    "RepairJournal", "store_fingerprint",
]
