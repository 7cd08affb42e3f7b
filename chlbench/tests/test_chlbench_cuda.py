"""The harness on the card at test size (skips without one): the same
runs as the CPU tests, through the hand-written kernels."""

import time

import pytest

from chlbench import bench

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["urand-plant"])
@pytest.mark.parametrize("trace", [False, True])
def test_card_run_is_correct(tiny_root, cuda_device, workload, trace):
    res = bench.run_cell(tiny_root, workload, 2 ** 31 + 99, 1.0, trace,
                         cuda_device, time.perf_counter())
    assert res["correct"] is True, res["checks"]
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert set(res["metrics"]) == {"sweep_device_ms",
                                       "build_roofline_pct",
                                       "device_idle_pct.build"}
        assert 0 < res["metrics"]["build_roofline_pct"]["value"] <= 100
    else:
        assert set(res["metrics"]) == {"build_trees_per_s",
                                       "peak_device_gib", "setup_s"}
