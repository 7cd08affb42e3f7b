"""Whole runs of the harness on the CPU at test size: the result line,
the checks, the faults the check must catch, the discovery of new files,
and the refusals of the command."""

import io
import json
import subprocess
import sys
import time

import numpy as np
import pytest

from chlbench import bench

CELLS = ("urand-plant",)
SEED = 2 ** 31 + 12345          # past 32 signed bits, as checks draw them


def run(root, workload, trace=False, seconds=0.5, seed=SEED):
    return bench.run_cell(root, workload, seed, seconds, trace, "cpu",
                          time.perf_counter())


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct_and_prints_the_contract_line(
        tiny_root, workload, trace):
    res = run(tiny_root, workload, trace)
    out, err = io.StringIO(), io.StringIO()
    bench.emit(res, out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device"] + (["breakdown"] if "breakdown" in line
                                       else []) + ["checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    checks = line["checks"]
    assert checks and all(c["value"] <= c["limit"] for c in checks.values())
    tail = err.getvalue().strip().splitlines()[-len(checks):]
    assert tail == [f"check {k} = {c['value']} (limit {c['limit']})"
                    for k, c in checks.items()]
    if trace:
        # per-layer metrics read the device trace: none on the CPU
        assert line["metrics"] == {}
    else:
        # the CPU has no device memory to report
        assert set(line["metrics"]) == {"build_trees_per_s", "setup_s"}
        assert line["metrics"]["build_trees_per_s"]["unit"] == "trees/s"


def _inputs(root, config, seed):
    b = root / "chlbench"
    drv = bench.load_module(b / "drivers/plant_cycles.py")
    cfg = json.loads((b / f"configs/{config}.json").read_text())
    mix = json.loads((b / "traffic/plant-top8.json").read_text())
    return drv.inputs(b, cfg, mix, seed)


def test_the_seed_draws_the_urand_numbering(tiny_root):
    """Another seed serves the same graph, weights and ranking under
    another vertex numbering: the roots are the same vertices."""
    one, same, other = (_inputs(tiny_root, "chl_urand22", s)
                        for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(x, y) for x, y in zip(one[1:], same[1:]))
    n, src, dst, w, rank, roots, _ = one
    _, src2, dst2, w2, rank2, roots2, _ = other
    assert not np.array_equal(src, src2)
    assert np.array_equal(w, w2)
    # the numbering that maps one onto the other: by rank, a permutation
    to = np.empty(n, np.int64)
    to[np.argsort(rank)] = np.argsort(rank2)
    assert np.array_equal(to[src], src2) and np.array_equal(to[dst], dst2)
    assert np.array_equal(to[roots], roots2)


def _state_unchanged(monkeypatch):
    from repro_torch.engine import sink
    monkeypatch.setattr(sink.DenseSink, "insert",
                        lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.engine.policies import PlantPolicy
    step = PlantPolicy.step

    def half(self, st, sink):
        valid = st.valid.copy()
        valid[len(valid) // 2:] = False
        return step(self, st._replace(valid=valid), sink)
    monkeypatch.setattr(PlantPolicy, "step", half)


def _answer_altered(monkeypatch):
    from repro_torch.engine import policies
    plant = policies.plant_batch

    def altered(*a, **k):
        tb = plant(*a, **k)
        dist = tb.dist.clone()
        dist[:, dist.shape[1] // 2] += 1
        return tb._replace(dist=dist)
    monkeypatch.setattr(policies, "plant_batch", altered)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_batch",
                              "answer_altered"])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(
        tiny_root, monkeypatch, workload, fault):
    fault(monkeypatch)
    res = run(tiny_root, workload)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_new_config_mix_and_metric_are_found_from_files(tiny_root):
    """A later change adds a configuration, a traffic mix and a metric as
    new files and entries only; the harness runs them unchanged."""
    b = tiny_root / "chlbench"
    cfg = json.loads((b / "configs/chl_urand22.json").read_text())
    cfg.update(name="chl_urand8", scale=8, n=256, cap=16)
    (b / "configs/chl_urand8.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic/plant-top8.json").read_text())
    mix.update(trees=6)
    (b / "traffic/plant-top6.json").write_text(json.dumps(mix))
    (b / "metrics/batches_done.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    (b / "metrics/never_read.py").write_text(
        "def read(run):\n    return None\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "chl_urand8", "source": "test",
                            "file": "chlbench/configs/chl_urand8.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "urand8-plant",
                              "config": "chl_urand8",
                              "traffic": "plant-top6", "chips": 1,
                              "why": "test"})
    for name in ("batches_done", "never_read"):
        spec["end_to_end"].append({"name": name, "unit": "batches",
                                   "better": "higher", "bound": 0.01,
                                   "source": "host_clock",
                                   "workloads": ["urand8-plant"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))

    res = run(tiny_root, "urand8-plant")
    assert res["correct"] is True
    assert res["metrics"]["batches_done"]["value"] >= 2       # 6 trees / 4
    assert "never_read" not in res["metrics"]
    # the cells already there do not report the new cell's metric
    assert "batches_done" not in run(tiny_root, "urand-plant")["metrics"]


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["jax.numpy", "repro_torch.engine", "repro.core", "jaxlib",
             "flax.linen", "reprox", "numpy", "jax_tools", "chlbench.bench"]
    assert bench.forbidden_modules(names) == ["flax", "jax", "jaxlib",
                                              "repro"]
    assert bench.forbidden_modules(["repro_torch", "chlbench"]) == []


def test_a_run_loads_no_jax_and_no_reference_package(tiny_root):
    """In a fresh process, a whole run leaves none of the forbidden
    modules loaded."""
    here = bench.Path(bench.__file__).resolve().parents[1]
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(here)!r}, {str(here / 'src')!r}]\n"
        "from chlbench import bench\n"
        f"r = bench.run_cell(bench.Path({str(tiny_root)!r}), 'urand-plant',"
        " 3, 0.3, False, 'cpu', time.perf_counter())\n"
        "assert r['correct'], r\n"
        "print(bench.forbidden_modules(list(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_refuses_without_cuda_or_the_port(tmp_path):
    """Without CUDA, and in a directory that holds only BENCHMARK.json
    and the benchmark's files, the command exits non-zero and prints no
    result."""
    import shutil
    root = bench.Path(bench.__file__).resolve().parents[1]
    shutil.copytree(root / "chlbench", tmp_path / "chlbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "chlbench/run.py", "--workload", "urand-plant",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
