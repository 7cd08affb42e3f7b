"""Serve-step factory of the LM zoo (training lands beside it)."""

from repro_torch.train.trainer import make_serve_fns

__all__ = ["make_serve_fns"]
