"""The port's fault-injection smoke (``repro_torch.launch.ft_smoke``)
on the CPU: all six legs pass (real child processes killed with
``os._exit`` at ``checkpoint.commit``, ``artifact.save.commit`` and
``repair.merge``, each recovered bit-identically; a flipped shard
byte rejected; healthy serving and a tripped breaker), and leg 1's
reference artifact equals the reference package's build of the same
graph and plan, array for array.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest

from repro.graphs import grid_road
from repro.graphs.ranking import betweenness_ranking
from repro.index import BuildPlan, build
from repro_torch.ft.harness import assert_index_bit_identical, index_arrays
from repro_torch.launch import ft_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """One run of the matrix at its default size (road, n = 144) on the
    CPU; its children find the package through ``PYTHONPATH``."""
    wd = str(tmp_path_factory.mktemp("ft") / "work")
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.path.join(ROOT, "src") + (
        os.pathsep + old if old else "")
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            ft_smoke.main(["--workdir", wd, "--device", "cpu"])
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH")
        else:
            os.environ["PYTHONPATH"] = old
    return wd, buf.getvalue()


def test_ft_smoke_passes_all_legs_on_cpu(smoke):
    _, out = smoke
    for leg in range(1, 7):
        assert f"[{leg}/6]" in out
    assert "rejected as expected" in out
    assert out.rstrip().endswith("ft_smoke: all 6 legs passed")


def test_ft_smoke_reference_build_equals_the_reference_package(
        smoke, tmp_path):
    wd, _ = smoke
    g = grid_road(12, 12, seed=0)
    ref = build(g, betweenness_ranking(g, samples=16),
                BuildPlan(algo="plant", batch=8, store="sharded", shards=2))
    ref_dir = ref.save(str(tmp_path / "ref"))
    assert_index_bit_identical(os.path.join(wd, "ref_index"), ref_dir)
    arrays = index_arrays(ref_dir)
    assert sorted(arrays) == ["rank"] + [f"shard_{k}/{x}" for k in (0, 1)
                                         for x in ("count", "dist", "hubs")]
    assert int(sum(arrays[f"shard_{k}/count"].sum() for k in (0, 1))) == \
        ref.total_labels > g.n


def test_ft_smoke_recovered_artifacts_agree(smoke):
    """Both crash-resumed builds equal leg 1's; the replayed repair
    equals the uninterrupted one and differs from the build."""
    wd, _ = smoke
    ref = os.path.join(wd, "ref_index")
    for d in ("a_index", "b_index"):
        assert_index_bit_identical(os.path.join(wd, d), ref)
    assert_index_bit_identical(os.path.join(wd, "repair_crash"),
                               os.path.join(wd, "repair_ref"))
    built = index_arrays(ref)
    repaired = index_arrays(os.path.join(wd, "repair_ref"))
    assert any(not np.array_equal(repaired[k], built[k]) for k in built)
    assert not os.path.exists(os.path.join(wd, "repair_crash")
                              + ".repair_journal.json")
