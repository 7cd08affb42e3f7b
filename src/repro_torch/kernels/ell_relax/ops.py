"""`ell_sweep`: the one entry point the sweep driver calls.

The route is decided once per fixpoint, by `resolve_sweep_backend`
from the tensors' device and the window plan, and handed to every
sweep as ``layout``; `ell_sweep` does not decide again. Routes, with no
fallback from one to another:

- a CUDA tensor with a layout: the source-windowed kernel
  (`windowed.ell_relax_windowed`);
- a CUDA tensor without one (the batch's two source planes fit half
  the card's L2): the dense kernel (`ell_relax.ell_relax`), which
  handles any B, n and deg itself;
- a CPU tensor: the plain version (`ref.ell_sweep_bucketed_plain` with
  a layout, else `ref.ell_sweep_plain`).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.kernels.ell_relax.ell_relax import ell_relax
from repro_torch.kernels.ell_relax.layout import (BucketedEll, WindowPlan,
                                                  sweep_layout)
from repro_torch.kernels.ell_relax.ref import (ell_sweep_bucketed_plain,
                                               ell_sweep_plain)
from repro_torch.kernels.ell_relax.windowed import ell_relax_windowed


def resolve_sweep_backend(ell_src, ell_w, batch: int, *,
                          layout: Optional[BucketedEll] = None
                          ) -> Optional[BucketedEll]:
    """The layout sweeps of ``batch`` trees over this adjacency run on,
    or None for the dense route (kernel or plain by device). A given
    multi-window ``layout`` wins; otherwise the card's L2 decides (the
    CPU has none, so it gets no layout)."""
    if layout is not None and layout.num_windows > 1:
        return layout
    return sweep_layout(ell_src, ell_w, bb=batch)


def windowed_note(n: int, batch: int, plan: WindowPlan) -> str:
    """`BuildReport.notes` entry for a build whose sweeps run the
    source-windowed kernel, with the window geometry."""
    return (f"ell_relax: n={n} runs source-windowed sweeps because its "
            f"{batch}-tree source planes ({8 * batch * n} B) exceed half "
            f"the card's L2 (window={plan.window}, "
            f"num_windows={plan.num_windows}); each pass gathers from one "
            "L2-resident window.")


def ell_sweep(dist, mrank, prop, alive, ell_src, ell_w, rank, *,
              layout: Optional[BucketedEll] = None):
    """One frontier-gated relaxation sweep.

    dist f32 [B, n]; mrank i32 [B, n]; prop f32 [B, n] (dist masked to
    +inf at blocked / inactive sources); alive bool [B] (False retires
    the tree); ell_src i32 / ell_w f32 [n, deg]; rank i32 [n];
    ``layout``: this adjacency's `BucketedEll` for the windowed route,
    None for the dense one.
    Returns (new_dist f32 [B, n], new_mrank i32 [B, n]).
    """
    if dist.device.type == "cuda":
        if layout is not None:
            return ell_relax_windowed(dist, mrank, prop, alive, layout,
                                      rank)
        return ell_relax(dist, mrank, prop, alive, ell_src, ell_w, rank)
    if dist.device.type != "cpu":
        raise ValueError(f"ell_sweep: no kernel for {dist.device}")
    if layout is not None:
        return ell_sweep_bucketed_plain(dist, mrank, prop, alive, layout,
                                        rank)
    return ell_sweep_plain(dist, mrank, prop, alive, ell_src, ell_w, rank)
