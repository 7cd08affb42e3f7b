"""Per-shard query routing for partitioned label stores (sharded, spill
and compressed).

A full answer reduces over all K shards for every query, but
shard k can contribute to ``(u, v)`` only when both endpoints hold at
least one label whose hub k owns; otherwise its partial minimum is +inf.
The routing table is the store's per-shard label counts
(``store.shard_counts()``, host ``[K, n]``): each batch runs shard k's
partial query only over the queries active in it, on the store's
device, and folds the partials back with a minimum. Dropped (query,
shard) pairs contribute only +inf to the f32 minimum, so the routed
answer equals the full reduction bit for bit. For a spill store this
is also an I/O saving: only the owning shards' mapped files are paged
in at all.

Degradation: a shard whose read fails (``OSError`` or ``ValueError``:
a refused launch, a corrupt segment, a spill shard's mapped page gone
bad) is quarantined, recorded in
:attr:`RoutedAnswer.quarantined` and never retried; queries that need it
raise :class:`ShardUnavailableError` (an unreadable shard surfaces as an
error, never as a too-large distance), and the service's ``health()``
lists the quarantine set. Queries whose endpoints hold no labels in the
bad shard are unaffected.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


class ShardUnavailableError(RuntimeError):
    """A query needs a quarantined shard: its answer would be wrong, not
    merely slow, so it is refused."""

    def __init__(self, shard: int, reason: str):
        super().__init__(
            f"label shard {shard} is quarantined ({reason}); queries "
            "needing it cannot be answered until the artifact is "
            "repaired or reloaded")
        self.shard = shard
        self.reason = reason


def _host_ids(x) -> np.ndarray:
    """Vertex ids (array-like or tensor) as a 1-D host int64 array."""
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.atleast_1d(np.asarray(x)).astype(np.int64).reshape(-1)


class RoutedAnswer:
    """``answer(u, v) -> dist f32 [Q]`` (a tensor on the store's device)
    that runs each shard only over the queries whose two endpoints both
    hold labels in it. Exact (see the module docstring); meaningful for
    ``num_shards > 1``."""

    def __init__(self, store):
        self._store = store
        self._has = store.shard_counts() > 0        # [K, n] host bools
        self.num_shards = self._has.shape[0]
        #: shard -> reason, set on the first failed read; a quarantined
        #: shard is never retried
        self.quarantined: Dict[int, str] = {}

    def __call__(self, u, v) -> torch.Tensor:
        u, v = _host_ids(u), _host_ids(v)
        dev = self._store.device
        u_d = torch.as_tensor(u, device=dev)
        v_d = torch.as_tensor(v, device=dev)
        best = torch.full((len(u),), torch.inf, dtype=torch.float32,
                          device=dev)
        for k in range(self.num_shards):
            mask = self._has[k, u] & self._has[k, v]
            if not mask.any():
                continue                 # no endpoint pair lives here
            if k in self.quarantined:
                raise ShardUnavailableError(k, self.quarantined[k])
            idx = torch.as_tensor(np.nonzero(mask)[0], device=dev)
            try:
                d, _ = self._store.query_shard_device(k, u_d[idx],
                                                      v_d[idx])
            except (OSError, ValueError) as e:
                self.quarantined[k] = f"{type(e).__name__}: {e}"
                raise ShardUnavailableError(
                    k, self.quarantined[k]) from e
            best[idx] = torch.minimum(best[idx], d)
        return best


def make_routed_answer_fn(store) -> RoutedAnswer:
    """The routed answer callable (its class carries the quarantine
    state)."""
    return RoutedAnswer(store)
