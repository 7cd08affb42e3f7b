"""Hot-pair LRU answer cache for the serving tier.

Real PPSD traffic is heavily skewed — a handful of popular endpoint
pairs dominate "millions of users" — so a small exact cache in front
of the kernel absorbs most of the load. The cache stores the *served*
f32 distance verbatim, so a hit is bit-identical to recomputing it;
it is a pure memoization layer, toggleable per service.

Undirected PPSD distances are symmetric (the intersection
``min over common hubs of d(u,x)+d(v,x)`` is the same f32 value either
way — addition is commutative and the candidate set is identical), so
by default ``(u, v)`` and ``(v, u)`` share one entry. Serving a
directed index through a raw answer fn should construct the cache with
``symmetric=False``.

Mutating the index invalidates every cached answer at once: each
entry carries the **epoch** it was written under, ``get`` refuses (and
evicts) entries from an older epoch, and :meth:`invalidate` bumps the
epoch in O(1) — stale entries age out lazily instead of paying an
O(capacity) sweep on the mutation path.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np


class AnswerCache:
    """Bounded LRU of ``(u, v) -> f32 distance``."""

    def __init__(self, capacity: int, symmetric: bool = True):
        if capacity < 1:
            raise ValueError("AnswerCache needs capacity >= 1")
        self.capacity = int(capacity)
        self.symmetric = bool(symmetric)
        self.epoch = 0
        self._d: "OrderedDict[tuple, tuple]" = OrderedDict()

    def _key(self, u: int, v: int) -> tuple:
        if self.symmetric and v < u:
            return (v, u)
        return (u, v)

    def get(self, u: int, v: int) -> Optional[np.float32]:
        key = self._key(u, v)
        entry = self._d.get(key)
        if entry is None:
            return None
        epoch, val = entry
        if epoch != self.epoch:          # written pre-mutation: stale
            del self._d[key]
            return None
        self._d.move_to_end(key)
        return val

    def put(self, u: int, v: int, value) -> None:
        key = self._key(u, v)
        self._d[key] = (self.epoch, np.float32(value))
        self._d.move_to_end(key)
        while len(self._d) > self.capacity:
            self._d.popitem(last=False)

    def __len__(self) -> int:
        return len(self._d)

    def clear(self) -> None:
        self._d.clear()

    def invalidate(self) -> None:
        """Mark every current entry stale (O(1)); a mutated index can
        never serve a pre-mutation hit."""
        self.epoch += 1
