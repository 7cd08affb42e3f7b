"""The least-work count against cases worked by hand."""

import numpy as np
import pytest

from chlbench.counts import least_work

# 0-1, 1-2 twice, a self loop at 2, 2-3: the simple graph is the path
# 0-1-2-3, in-degrees (1, 2, 2, 1), sorted (1, 1, 2, 2)
PATH_SRC = np.array([0, 1, 2, 2, 3], np.int32)
PATH_DST = np.array([1, 2, 1, 2, 2], np.int32)


def test_in_degree_prefix_of_a_path_with_a_repeat_and_a_loop():
    p = least_work.in_degree_prefix(4, PATH_SRC, PATH_DST)
    assert p.tolist() == [0, 1, 2, 4, 6]


def test_in_degree_prefix_counts_isolated_vertices_as_zero():
    p = least_work.in_degree_prefix(6, PATH_SRC, PATH_DST)
    assert p.tolist() == [0, 0, 0, 1, 2, 4, 6]


@pytest.mark.parametrize("explored, batch, want", [
    # 2 trees explored all 4 vertices: union 4, all 6 in-edges;
    # 8 * 8 + 4 * 4 + 8 * 6 bytes, 3 * 6 operations
    (8, 2, (128, 18)),
    # 5 pairs over 2 trees: at least 2 vertices, their least in-edges 2;
    # 8 * 5 + 4 * 2 + 8 * 2 bytes, 3 * 2 operations
    (5, 2, (64, 6)),
    # one tree, one vertex (its root): 1 in-edge at least
    (1, 1, (8 + 4 + 8, 3)),
    (0, 4, (0, 0)),
])
def test_batch_work_by_hand(explored, batch, want):
    p = least_work.in_degree_prefix(4, PATH_SRC, PATH_DST)
    assert least_work.batch_work(explored, batch, p) == want


def test_batch_that_reaches_every_vertex_by_hand():
    """4 trees each reach all n = 4096^2 vertices of a graph whose
    70,447,922 arcs are then all read:
    8 * 4n + 4n + 8 * 70,447,922 = 1,167,563,152 B, bandwidth-bound at
    3.35 TB/s: 348.5 us."""
    n, arcs = 4096 * 4096, 70_447_922
    prefix = np.zeros(n + 1, np.int64)
    prefix[-1] = arcs
    nbytes, ops = least_work.batch_work(4 * n, 4, prefix)
    assert nbytes == 1_167_563_152
    assert ops == 3 * arcs
    pk = least_work.peaks()
    assert least_work.least_seconds(nbytes, ops, pk) == pytest.approx(
        1_167_563_152 / 3.35e12)
    assert least_work.least_seconds(nbytes, ops, pk) == pytest.approx(
        348.5e-6, rel=1e-3)


def test_least_seconds_takes_the_slower_bound():
    pk = {"hbm_bytes_per_s": 10.0, "f32_ops_per_s": 100.0}
    assert least_work.least_seconds(50, 100, pk) == 5.0      # bytes
    assert least_work.least_seconds(5, 1000, pk) == 10.0     # operations


def test_peaks_are_the_h100_data_sheet_rates():
    pk = least_work.peaks()
    assert pk["hbm_bytes_per_s"] == 3.35e12
    assert pk["f32_ops_per_s"] == 67e12
    assert pk["power_limit_w"] == 700


def test_count_is_a_lower_bound_of_a_plain_batch(tiny_root):
    """On the test graph, a batch's count is at most what a plain
    sweep loop moves in one sweep of every tree (each (tree, vertex)
    written, every arc and rank read), so a share of it cannot pass
    100 % of any sweep loop that runs at least one sweep."""
    import json
    from chlbench import bench
    cfg = json.loads((tiny_root / "chlbench/configs/chl_urand22.json")
                     .read_text())
    gen = bench.load_module(tiny_root / "chlbench/graphs/urand.py")
    n, src, dst, w = gen.edges(cfg, np.random.default_rng(3))
    p = least_work.in_degree_prefix(n, src, dst)
    nbytes, ops = least_work.batch_work(4 * n, 4, p)
    one_sweep = 4 * n * 8 + 2 * len(src) * 8 + n * 4
    # the count reads the simple graph: a repeated pair is one arc
    assert 0 < p[-1] <= 2 * len(src)
    assert nbytes <= one_sweep
