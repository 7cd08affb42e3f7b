"""`ell_sweep`: the one entry point the sweep driver calls.

On CUDA tensors it launches the hand-written kernel (which handles any
B, n and deg itself: no padding); on CPU tensors it runs the plain
PyTorch version. There is no fallback from one to the other.
"""

from __future__ import annotations

from repro_torch.kernels.ell_relax.ell_relax import ell_relax
from repro_torch.kernels.ell_relax.ref import ell_sweep_plain


def ell_sweep(dist, mrank, prop, alive, ell_src, ell_w, rank):
    """One frontier-gated relaxation sweep.

    dist f32 [B, n]; mrank i32 [B, n]; prop f32 [B, n] (dist masked to
    +inf at blocked / inactive sources); alive bool [B] (False retires
    the tree); ell_src i32 / ell_w f32 [n, deg]; rank i32 [n].
    Returns (new_dist f32 [B, n], new_mrank i32 [B, n]).
    """
    if dist.device.type == "cuda":
        return ell_relax(dist, mrank, prop, alive, ell_src, ell_w, rank)
    if dist.device.type != "cpu":
        raise ValueError(f"ell_sweep: no kernel for {dist.device}")
    return ell_sweep_plain(dist, mrank, prop, alive, ell_src, ell_w, rank)
