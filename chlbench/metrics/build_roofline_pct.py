"""``build_roofline_pct``: the least time the window's batches need
(`counts/least_work.py`, from each batch's record) over the device's
busy time in the traced window, in percent."""

from chlbench.counts import least_work


def read(run):
    if run.busy_s is None or run.in_degree_prefix is None:
        return None
    least = sum(least_work.least_seconds(
        *least_work.batch_work(r.explored, run.batch, run.in_degree_prefix),
        run.peaks) for r in run.records if r.explored)
    if not least:
        return None
    return 100.0 * least / run.busy_s
