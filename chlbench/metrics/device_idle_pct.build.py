"""``device_idle_pct.build``: the share of the traced window in which no
operation ran on the device, in percent."""


def read(run):
    if run.busy_s is None or not run.traced_window_s:
        return None
    return 100.0 * (1.0 - run.busy_s / run.traced_window_s)
