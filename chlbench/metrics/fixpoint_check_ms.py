"""``fixpoint_check_ms``: the mean device gap of one fixpoint check of
the window's sweep loops, from the port's ``relax.check`` spans
(`repro_torch.tracing`): the stream's time from just before the ``any``
reduction to just before the loop's next op, which holds the
reduction, the one-word read and the time the stream sat empty while
the host waited."""

from chlbench import program_trace


def read(run):
    snap = program_trace.snapshot(run)
    return None if snap is None else program_trace.mean_device_ms(
        snap["checks"])
