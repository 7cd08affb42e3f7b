"""``sweep_device_ms``: the device's busy time over the traced window
(union of its operations' spans) per relaxation sweep the window's
batches ran (their ``SuperstepRecord.sweeps``)."""


def read(run):
    sweeps = sum(r.sweeps or 0 for r in run.records)
    if run.busy_s is None or not sweeps:
        return None
    return run.busy_s * 1e3 / sweeps
