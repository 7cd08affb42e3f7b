"""The paper's algorithms: label tables, the PLaNT and GLL batch steps,
DGLL and the Hybrid over a node mesh, the PLL oracle, the directed
labels' entry points (`repro_torch.core.directed`) and the QLSN / QFDL /
QDOL query modes (`repro_torch.core.query`).

The per-algorithm ``*_chl`` constructors re-exported here are the
**deprecated engine layer**: application code builds through
`repro_torch.index` (``BuildPlan`` -> ``build()`` -> ``CHLIndex``), and
the re-exports below emit a ``DeprecationWarning`` when called. The
defining modules (`repro_torch.core.plant` etc.) stay warning-free:
that is the surface `repro_torch.index.build` and the tests drive.
"""

import functools
import warnings

from repro_torch.core.dgll import assign_roots, make_node_mesh
from repro_torch.core.dgll import dgll_chl as _dgll_chl
from repro_torch.core.gll import BatchLabels, clean_superstep, construct_batch
from repro_torch.core.gll import gll_chl as _gll_chl
from repro_torch.core.gll import lcc_chl as _lcc_chl
from repro_torch.core.gll import parapll_chl as _parapll_chl
from repro_torch.core.hybrid import hybrid_chl as _hybrid_chl
from repro_torch.core.hybrid import plant_distributed_chl as _plant_dist_chl
from repro_torch.core.labels import (LabelOverflowError, LabelTable,
                                     cover_best_rank, cover_distance,
                                     default_cap, delete_mask, empty,
                                     from_numpy_sets, hub_distance_map,
                                     insert_batch, merge, query_pairs,
                                     to_numpy_sets, total_labels)
from repro_torch.core.plant import TreeBatch, plant_batch
from repro_torch.core.plant import plant_chl as _plant_chl
from repro_torch.core.pll import (LabelSets, average_label_size,
                                  chl_by_definition, pll_directed,
                                  pll_undirected, query_distance,
                                  query_distance_directed)


def _deprecated_shim(fn, name):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        warnings.warn(
            f"repro_torch.core.{name} is a deprecated engine-layer shim; "
            "build through repro_torch.index "
            "(build(g, rank, BuildPlan(algo=...)))",
            DeprecationWarning, stacklevel=2)
        return fn(*args, **kwargs)
    return wrapper


plant_chl = _deprecated_shim(_plant_chl, "plant_chl")
gll_chl = _deprecated_shim(_gll_chl, "gll_chl")
lcc_chl = _deprecated_shim(_lcc_chl, "lcc_chl")
parapll_chl = _deprecated_shim(_parapll_chl, "parapll_chl")
dgll_chl = _deprecated_shim(_dgll_chl, "dgll_chl")
hybrid_chl = _deprecated_shim(_hybrid_chl, "hybrid_chl")
plant_distributed_chl = _deprecated_shim(_plant_dist_chl,
                                         "plant_distributed_chl")

__all__ = ["BatchLabels", "LabelOverflowError", "LabelSets", "LabelTable",
           "TreeBatch", "assign_roots", "average_label_size",
           "chl_by_definition", "clean_superstep", "construct_batch",
           "cover_best_rank", "cover_distance", "default_cap",
           "delete_mask", "dgll_chl", "empty", "from_numpy_sets",
           "gll_chl", "hub_distance_map", "hybrid_chl", "insert_batch",
           "lcc_chl", "make_node_mesh", "merge", "parapll_chl",
           "plant_batch", "plant_chl", "plant_distributed_chl",
           "pll_directed", "pll_undirected", "query_distance",
           "query_distance_directed", "query_pairs", "to_numpy_sets",
           "total_labels"]
