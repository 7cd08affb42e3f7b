"""The LM zoo: the ten architectures' modules, the training loss,
prefill and cached decode (the reference package's ``models``)."""

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (LM, abstract_params, init_params,
                                      init_serve_state, loss_fn)

__all__ = ["LM", "ModelConfig", "abstract_params", "init_params",
           "init_serve_state", "loss_fn"]
