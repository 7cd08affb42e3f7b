"""``sweep_active_edge_pct``: the share of the folds the window's sweeps
did whose source was in the frontier, in percent: the sum over sweeps of
``active_edges`` (the active sources' finite out-degrees, summed over
trees) over the sum of ``trees_alive`` × the adjacency's finite arcs
(a sweep folds every finite in-edge of every live tree). Counted by the
port where the frontier lives (`repro_torch.tracing`), on the device."""

from chlbench import program_trace


def read(run):
    snap = program_trace.snapshot(run)
    if snap is None:
        return None
    folds = sum(r["trees_alive"] * r["edges"] for r in snap["sweeps"])
    if not folds:
        return None
    return 100.0 * sum(r["active_edges"] for r in snap["sweeps"]) / folds
