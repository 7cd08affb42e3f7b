from repro_torch.kernels.label_query.label_query import KERNEL, label_query
from repro_torch.kernels.label_query.ops import intersect, query_table
from repro_torch.kernels.label_query.ref import label_query_ref

__all__ = ["KERNEL", "intersect", "label_query", "label_query_ref",
           "query_table"]
