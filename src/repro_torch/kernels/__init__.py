"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- `ell_relax`: the fused pull-ELL (min, +, max-rank) relaxation sweep
  under every construction algorithm, while the batch's two source
  planes fit half the card's L2;
- `ell_relax_windowed`: the same sweep past that, window-major over a
  source-bucketed layout (`ell_relax/layout.py`), with each window's
  gathers L2-resident;
- `label_query`: the PPSD label intersection with its witnessing hub;
- `minplus`: the lexicographic (min, +) product with a max-rank
  payload, under dense-block PLaNT (`minplus.plant_fixpoint_dense`).

Each package holds its kernels' ``csrc/<name>.cu`` (CUDA C++ for
sm_90a, built on first use by `repro_torch.kernels.cuda`), a ctypes
wrapper per kernel with its launch count, a plain ``ref.py`` and an
``ops.py`` that dispatches by device: a kernel for CUDA tensors, the
plain version for CPU ones.
"""

from repro_torch.kernels.cuda import CudaKernel, build_all


def all_kernels():
    """Every hand-written kernel of the port."""
    from repro_torch.kernels.ell_relax import KERNEL as ELL_RELAX
    from repro_torch.kernels.ell_relax import WINDOWED_KERNEL
    from repro_torch.kernels.label_query import KERNEL as LABEL_QUERY
    from repro_torch.kernels.minplus import KERNEL as MINPLUS
    return [ELL_RELAX, WINDOWED_KERNEL, LABEL_QUERY, MINPLUS]


__all__ = ["CudaKernel", "all_kernels", "build_all"]
