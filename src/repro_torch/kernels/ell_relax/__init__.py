from repro_torch.kernels.ell_relax.ell_relax import KERNEL, ell_relax
from repro_torch.kernels.ell_relax.ops import ell_sweep
from repro_torch.kernels.ell_relax.ref import ell_sweep_plain, ell_sweep_ref

__all__ = ["KERNEL", "ell_relax", "ell_sweep", "ell_sweep_plain",
           "ell_sweep_ref"]
