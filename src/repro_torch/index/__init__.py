"""repro_torch.index — build-plan -> CHL-index artifact API::

    from repro_torch.index import BuildPlan, CHLIndex, build

    idx = build(g, rank)                 # the hybrid, one node per card
    idx = build(g, rank, BuildPlan(algo="dgll"),
                mesh=NodeMesh.logical(8, "cuda"))  # 8 nodes on one card
    idx.query(u, v)
    idx.serve(mode="qlsn")               # or "qfdl", "qdol"
    idx.save("run/index")
    idx = CHLIndex.load("run/index")
    build(g, rank, BuildPlan(algo="plant", store="sharded", shards=4))
    build(g, rank, BuildPlan(algo="plant", store="compressed",
                             codec="u16", quant_exact=True))
    CHLIndex.load("run/index", store="spill")       # memory-mapped
    build(digraph, rank, BuildPlan(algo="directed"))  # L_out / L_in
"""

from repro_torch.index.artifact import CHLIndex, rank_hash
from repro_torch.index.build import build
from repro_torch.index.plan import ALGOS, DISTRIBUTED_ALGOS, BuildPlan
from repro_torch.index.quant import (DIST_CODECS, QuantizationError,
                                     QuantPrecisionError, QuantRangeError)
from repro_torch.index.report import (BuildReport, OverflowEvent,
                                      SuperstepStat, normalize_stats)
from repro_torch.index.store import (LOAD_STORE_KINDS, CompressedStore,
                                     CorruptArtifactError, DenseStore,
                                     LabelStore, ShardedStore, SpillStore)

__all__ = ["ALGOS", "BuildPlan", "BuildReport", "CHLIndex",
           "CompressedStore", "CorruptArtifactError", "DIST_CODECS",
           "DISTRIBUTED_ALGOS", "DenseStore", "LOAD_STORE_KINDS",
           "LabelStore", "OverflowEvent", "QuantPrecisionError",
           "QuantRangeError", "QuantizationError", "ShardedStore",
           "SpillStore", "SuperstepStat", "build", "normalize_stats",
           "rank_hash"]
