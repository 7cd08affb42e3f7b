from repro_torch.kernels.ell_relax.ell_relax import KERNEL, ell_relax
from repro_torch.kernels.ell_relax.layout import (
    BucketedEll, WindowPlan, WindowSegments, build_bucketed_ell,
    clear_layout_cache, kernel_fits, l2_bytes, layout_plan, sweep_layout, window_cap,
    window_plan)
from repro_torch.kernels.ell_relax.ops import (ell_sweep,
                                               resolve_sweep_backend,
                                               windowed_note)
from repro_torch.kernels.ell_relax.ref import (ell_sweep_bucketed_plain,
                                               ell_sweep_plain, ell_sweep_ref)
from repro_torch.kernels.ell_relax.windowed import KERNEL as WINDOWED_KERNEL
from repro_torch.kernels.ell_relax.windowed import ell_relax_windowed

__all__ = ["BucketedEll", "KERNEL", "WINDOWED_KERNEL", "WindowPlan",
           "WindowSegments", "build_bucketed_ell", "clear_layout_cache",
           "ell_relax", "ell_relax_windowed", "ell_sweep",
           "ell_sweep_bucketed_plain", "ell_sweep_plain", "ell_sweep_ref",
           "kernel_fits", "l2_bytes", "layout_plan", "resolve_sweep_backend",
           "sweep_layout", "window_cap", "window_plan", "windowed_note"]
