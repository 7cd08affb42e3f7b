"""``setup_s``: seconds from the process's start to the measured
window's: inputs, the port's graph build, device copies and layout, the
kernels' first build in a fresh checkout, and the warm-up."""


def read(run):
    return run.setup_s
