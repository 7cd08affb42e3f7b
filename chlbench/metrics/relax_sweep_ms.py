"""``relax_sweep_ms``: the mean device time of one relaxation sweep of
the window (gating ops, kernel and frontier compare), from the pair of
CUDA events the port records around each (`repro_torch.tracing`): the
inside counterpart of ``sweep_device_ms``."""

from chlbench import program_trace


def read(run):
    snap = program_trace.snapshot(run)
    return None if snap is None else program_trace.mean_device_ms(
        snap["sweeps"])
