"""Find a cell's files by name, run it once, and build the result line.

Everything that belongs to one configuration, traffic mix or metric is
found from the names in `BENCHMARK.json`:

- a cell's configuration: the file its ``configs`` entry names;
- its traffic mix: ``traffic/<traffic>.json``, whose ``kind`` names the
  driver ``drivers/<kind>.py``;
- each metric: its reader ``metrics/<name>.py``, a module with
  ``read(run) -> float | None`` (None: nothing to read, the metric is
  left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Iterable, List, Optional

#: top-level module names that must not be loaded by a run: JAX, its
#: libraries and the JAX package of this repository (whose name is a
#: prefix of the port's, so names are compared whole)
FORBIDDEN_TOP = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The forbidden top-level names among loaded module names."""
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN_TOP})


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path (metric names hold dots, so a reader
    is never imported by a dotted module name)."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = "chlbench_file_" + "".join(
        c if c.isalnum() else "_" for c in path.relative_to(
            path.parents[1]).as_posix())
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path) -> dict:
    return load_json(Path(root) / "BENCHMARK.json")


def bench_dir(root: Path) -> Path:
    return Path(root) / "chlbench"


def find_cell(spec: dict, workload: str):
    """The ``workloads`` entry named ``workload`` and its configuration
    entry."""
    cells = [c for c in spec["workloads"] if c["name"] == workload]
    if not cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {[c['name'] for c in spec['workloads']]}")
    cell = cells[0]
    cfg = [c for c in spec["configs"] if c["name"] == cell["config"]]
    if not cfg:
        raise KeyError(f"workload {workload!r} names the unknown "
                       f"configuration {cell['config']!r}")
    return cell, cfg[0]


def metrics_for(spec: dict, workload: str, group: str) -> List[dict]:
    """The ``group`` (``end_to_end`` or ``per_layer``) metrics that
    ``workload`` reports: those whose ``workloads`` list it, or that
    have no such list."""
    return [m for m in spec[group]
            if workload in m.get("workloads", [workload])]


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str, t0: float,
             spec: Optional[dict] = None) -> dict:
    """Set up, measure and check one run of ``workload``; returns the
    result line as a dict (the checks under ``checks``, its last key)."""
    root = Path(root)
    spec = load_spec(root) if spec is None else spec
    cell, cfg_entry = find_cell(spec, workload)
    bench = bench_dir(root)
    traffic = load_json(bench / "traffic" / f"{cell['traffic']}.json")
    driver = load_module(bench / "drivers" / f"{traffic['kind']}.py")
    ctx = SimpleNamespace(bench=bench,
                          config=load_json(root / cfg_entry["file"]),
                          traffic=traffic, seed=int(seed),
                          seconds=float(seconds), trace=bool(trace),
                          device=device, t0=t0)
    run = driver.run(ctx)

    group = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_for(spec, workload, group):
        value = load_module(bench / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": run.correct, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": run.device}
    if trace and run.breakdown is not None:
        result["breakdown"] = run.breakdown
    result["checks"] = run.checks
    return result


def emit(result: dict, out=None, err=None) -> None:
    """Print the checks as the last lines of standard error and the
    result as the last line of standard output."""
    out = sys.stdout if out is None else out
    err = sys.stderr if err is None else err
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=err, flush=True)
    print(json.dumps(result), file=out, flush=True)
