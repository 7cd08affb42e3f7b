from repro_torch.kernels.label_query.label_query import (
    KERNEL, label_query, label_query_pair_rows, label_query_rows)
from repro_torch.kernels.label_query.ops import (query_rows, query_table,
                                                query_table_pair)
from repro_torch.kernels.label_query.ref import label_query_ref

__all__ = ["KERNEL", "label_query", "label_query_pair_rows",
           "label_query_ref", "label_query_rows", "query_rows",
           "query_table", "query_table_pair"]
