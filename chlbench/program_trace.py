"""The program's own record of a traced window, for the per-layer
readers that read it.

While a ``torch.profiler`` session runs (here: `trace.DeviceTrace` over
the measured window of a ``--trace 1`` run), the port records spans and
per-sweep counters in `repro_torch.tracing`; `snapshot` hands that
record to a reader. A checkout whose port has no such module, and a run
without a device trace, give None: the reader then reads nothing.
"""


def snapshot(run):
    """The port's `repro_torch.tracing.snapshot()` for ``run``, or None
    where the run took no device trace or the port records nothing."""
    if run.busy_s is None:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def mean_device_ms(rows):
    """The mean ``device_ms`` of ``rows`` that have one; None if none
    has."""
    ms = [r["device_ms"] for r in rows if r["device_ms"] is not None]
    return sum(ms) / len(ms) if ms else None
