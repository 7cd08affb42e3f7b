"""Deterministic, shardable, resumable synthetic LM data (the reference
package's ``data``; numpy only)."""

from repro_torch.data.pipeline import DataConfig, DataState, SyntheticLM

__all__ = ["DataConfig", "DataState", "SyntheticLM"]
