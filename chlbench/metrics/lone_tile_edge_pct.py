"""``lone_tile_edge_pct``: the share of the adjacency's arcs that the
windowed kernel folds as lone tiles, in percent: segments (one
destination's in-edges inside one source window) longer than a block
stages, each folded by one block from device memory. 100 × the sum of
the sweep rows' ``lone_tile_edges`` over the sum of their ``edges``,
over the traced window's sweeps; the port counts them once per layout
(`repro_torch.tracing`, `kernels.ell_relax.layout.BucketedEll.counters`).
A port whose sweep rows carry no such count reads nothing."""

from chlbench import program_trace


def read(run):
    snap = program_trace.snapshot(run)
    if snap is None:
        return None
    rows = [r for r in snap["sweeps"] if "lone_tile_edges" in r]
    edges = sum(r["edges"] for r in rows)
    if not edges:
        return None
    return 100.0 * sum(r["lone_tile_edges"] for r in rows) / edges
