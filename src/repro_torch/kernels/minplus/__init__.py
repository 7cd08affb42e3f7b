from repro_torch.kernels.minplus.minplus import KERNEL, minplus
from repro_torch.kernels.minplus.ops import (dense_weights, minplus_product,
                                             plant_fixpoint_dense,
                                             plant_sweep_dense)
from repro_torch.kernels.minplus.ref import minplus_plain

__all__ = ["KERNEL", "dense_weights", "minplus", "minplus_plain",
           "minplus_product", "plant_fixpoint_dense", "plant_sweep_dense"]
