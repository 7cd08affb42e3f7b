"""The LM zoo's serving path: the ten architectures' modules, prefill
and cached decode (the reference package's ``models``)."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (LM, abstract_params, init_params,
                                      init_serve_state)

__all__ = ["LM", "ModelConfig", "abstract_params", "init_params",
           "init_serve_state"]
