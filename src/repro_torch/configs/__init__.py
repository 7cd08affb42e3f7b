"""Configurations: the CHL workload (``chl_*.py``: one
:class:`~repro_torch.configs.chl_common.ChlConfig` per graph regime, a
full-size ``CONFIG`` and a ``SMOKE`` cut) and the ten LM architectures
(one file each with ``CONFIG``, ``SMOKE`` and ``SPEC``; the registry is
:mod:`repro_torch.configs.base`)."""

from repro_torch.configs.chl_common import ChlConfig

__all__ = ["ChlConfig"]
