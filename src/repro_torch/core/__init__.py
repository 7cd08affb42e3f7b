"""Label tables, the PLaNT and GLL batch steps, the PLL oracle and the
directed labels' entry points (`repro_torch.core.directed`)."""

from repro_torch.core.gll import (BatchLabels, clean_superstep,
                                  construct_batch, gll_chl, lcc_chl,
                                  parapll_chl)
from repro_torch.core.labels import (LabelOverflowError, LabelTable,
                                     cover_best_rank, cover_distance,
                                     default_cap, delete_mask, empty,
                                     from_numpy_sets, hub_distance_map,
                                     insert_batch, merge, query_pairs,
                                     to_numpy_sets, total_labels)
from repro_torch.core.plant import TreeBatch, plant_batch
from repro_torch.core.pll import (LabelSets, average_label_size,
                                  chl_by_definition, pll_directed,
                                  pll_undirected, query_distance,
                                  query_distance_directed)

__all__ = ["BatchLabels", "LabelOverflowError", "LabelSets", "LabelTable",
           "TreeBatch", "average_label_size", "chl_by_definition",
           "clean_superstep", "construct_batch", "cover_best_rank",
           "cover_distance", "default_cap", "delete_mask", "empty",
           "from_numpy_sets", "gll_chl", "hub_distance_map", "insert_batch",
           "lcc_chl", "merge", "parapll_chl", "plant_batch",
           "pll_directed", "pll_undirected", "query_distance",
           "query_distance_directed", "query_pairs",
           "to_numpy_sets", "total_labels"]
