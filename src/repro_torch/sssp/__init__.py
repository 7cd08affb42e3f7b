"""Shortest paths: the batched max-rank relaxation driver and the
Dijkstra oracles."""

from repro_torch.sssp.oracle import (all_pairs, dijkstra, dijkstra_maxrank,
                                     dijkstra_tree)
from repro_torch.sssp.relax import (DEFAULT_CHECK_EVERY, RelaxState,
                                    batched_sssp, batched_sssp_maxrank,
                                    combine_blocks, ell_layout, rank_block)

__all__ = ["DEFAULT_CHECK_EVERY", "RelaxState", "all_pairs", "batched_sssp",
           "batched_sssp_maxrank", "combine_blocks", "dijkstra",
           "dijkstra_maxrank", "dijkstra_tree", "ell_layout", "rank_block"]
