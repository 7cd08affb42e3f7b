"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- `ell_relax`: the fused pull-ELL (min, +, max-rank) relaxation sweep
  under every construction algorithm;
- `label_query`: the PPSD label intersection with its witnessing hub.

Each package holds ``csrc/<name>.cu`` (CUDA C++ for sm_90a, built on
first use by `repro_torch.kernels.cuda`), the ctypes wrapper with its
launch count, a plain ``ref.py`` and an ``ops.py`` that dispatches by
device: the kernel for CUDA tensors, the plain version for CPU ones.
"""

from repro_torch.kernels.cuda import CudaKernel, build_all


def all_kernels():
    """Every hand-written kernel of the port."""
    from repro_torch.kernels.ell_relax import KERNEL as ELL_RELAX
    from repro_torch.kernels.label_query import KERNEL as LABEL_QUERY
    return [ELL_RELAX, LABEL_QUERY]


__all__ = ["CudaKernel", "all_kernels", "build_all"]
