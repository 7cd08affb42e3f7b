"""The comparisons that decide ``correct``: label rows, exactly.

A row is one vertex's labels: its count, and its hubs and distances slot
by slot (padding included). Weights are integers and distances exact in
float32 below 2^24, so a sound program equals the reference bit for bit
and every limit is 0.
"""

from __future__ import annotations

import torch


def rows_differing(hubs, dist, count, ref_hubs, ref_dist, ref_count
                   ) -> torch.Tensor:
    """Per row: True where the two tables differ (device bool [rows])."""
    return ((hubs != ref_hubs).any(dim=1) | (dist != ref_dist).any(dim=1)
            | (count != ref_count))


def count_rows_differing(table, ref) -> int:
    """Rows of ``table`` (hubs, dist, count) that differ from ``ref``."""
    return int(rows_differing(*table[:3], *ref[:3]).sum())


def within(checks: dict) -> bool:
    """Every compared number (``{name: {"value", "limit"}}``) within its
    limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())
