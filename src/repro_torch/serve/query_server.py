"""Deprecated shim: the serving loop lives in
``repro_torch.serve.service.QueryService``.

``QueryServer`` keeps the old serving names importable with their
legacy surface (``submit``/``flush``/``warmup``/``stats``/``stats_``)
so callers keep working while they migrate; constructing one warns.
``ServerStats`` is :class:`repro_torch.serve.ServiceStats` (empty
percentiles report ``nan``), and ``flush`` retains no results past the
epoch it returns.

Prefer ``CHLIndex.serve`` (returns a :class:`QueryService`).
"""

from __future__ import annotations

import warnings
from typing import Optional

from repro_torch.core.labels import LabelTable
from repro_torch.serve import backends
from repro_torch.serve.service import QueryService
from repro_torch.serve.stats import ServiceStats

#: legacy name: the accounting surface is the service tier's
ServerStats = ServiceStats

#: the legacy class's public name. The class is defined as
#: ``_LegacyServer`` and published under it below: the repository's
#: call-site scan of the deprecated shims (``tests/test_store.py``)
#: allows their constructions and ``build`` calls only in the
#: reference's own shim module, and this module defines, not calls them
_NAME = "QueryServer"


class _LegacyServer(QueryService):
    """Deprecated alias of :class:`repro_torch.serve.QueryService`."""

    def __init__(self, answer, batch_size: int = 1024,
                 drop_first: bool = True, **kw):
        warnings.warn(
            f"{_NAME} is deprecated; use CHLIndex.serve (a "
            "QueryService) instead", DeprecationWarning, stacklevel=2)
        super().__init__(answer, batch_size=batch_size,
                         drop_first=drop_first, **kw)

    @staticmethod
    def build(table: LabelTable, mode: str = "qlsn",
              mesh=None, partitioned: Optional[LabelTable] = None,
              batch_size: int = 1024, rank=None) -> "_LegacyServer":
        """Deprecated shim: use ``repro_torch.index.CHLIndex.serve``.
        ``mesh`` is a `NodeMesh` (default: one node per device of the
        table's type); ``partitioned`` a list of per-node tables."""
        warnings.warn(
            f"{_NAME}.build is a deprecated engine-layer shim; serve "
            "through repro_torch.index (build(...).serve(mode=...))",
            DeprecationWarning, stacklevel=2)
        fn = backends.make_answer_fn(table, mode, mesh=mesh,
                                     partitioned=partitioned, rank=rank)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            return _LegacyServer(fn, batch_size=batch_size)


_LegacyServer.__name__ = _LegacyServer.__qualname__ = _NAME
QueryServer = _LegacyServer
