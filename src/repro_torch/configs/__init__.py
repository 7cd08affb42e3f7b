"""The CHL workload configurations (the reference package's
``configs/chl_*.py``): one :class:`~repro_torch.configs.chl_common.ChlConfig`
per graph regime, a full-size ``CONFIG`` and a ``SMOKE`` cut."""

from repro_torch.configs.chl_common import ChlConfig

__all__ = ["ChlConfig"]
