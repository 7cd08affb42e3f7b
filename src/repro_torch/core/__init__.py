"""Label tables and the PLaNT batch step."""

from repro_torch.core.labels import (LabelOverflowError, LabelTable,
                                     default_cap, empty, insert_batch,
                                     query_pairs, total_labels)
from repro_torch.core.plant import TreeBatch, plant_batch

__all__ = ["LabelOverflowError", "LabelTable", "TreeBatch", "default_cap",
           "empty", "insert_batch", "plant_batch", "query_pairs",
           "total_labels"]
