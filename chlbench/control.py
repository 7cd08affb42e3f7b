"""The control of the correctness check: the plain reference computed in
bfloat16 (the precision below the configurations' float32), put in the
program's place, at the cell's own size.

    python3 chlbench/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed it makes the cell's inputs as a run does and compares, as
a run does, the control's labels of the whole schedule, of its first
batch, and at the sampled rows, with the reference's in float64; it
prints one JSON line a seed with the numbers a run compares. The check
must read the control as not correct: a number above its limit (0).
The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]


def readings(root: Path, workload: str, seed: int, device: str) -> dict:
    import torch
    from chlbench import bench, check
    spec = bench.load_spec(root)
    cell, entry = bench.find_cell(spec, workload)
    b = bench.bench_dir(root)
    cfg = bench.load_json(root / entry["file"])
    mix = bench.load_json(b / "traffic" / f"{cell['traffic']}.json")
    driver = bench.load_module(b / "drivers" / f"{mix['kind']}.py")
    t0 = time.perf_counter()
    n, src, dst, w, rank, roots, sample = driver.inputs(b, cfg, mix, seed)
    ref_mod = bench.load_module(b / "reference" / f"{cfg['reference']}.py")
    kw = dict(trees=len(roots), cap=int(cfg["cap"]), device=device)
    exact = ref_mod.Reference(n, src, dst, w, rank, **kw)
    control = ref_mod.Reference(n, src, dst, w, rank, dtype=torch.bfloat16,
                                **kw)
    idx = torch.as_tensor(sample, device=device)
    whole_c, whole_e = control.table(len(roots)), exact.table(len(roots))
    part = min(len(roots), int(cfg["batch"]))
    full = (check.count_rows_differing(whole_c, whole_e)
            + check.count_rows_differing(control.table(part),
                                         exact.table(part)))
    sampled = check.count_rows_differing([x[idx] for x in whole_c],
                                         [x[idx] for x in whole_e])
    checks = {"full_rows_differing": {"value": full, "limit": 0},
              "sampled_rows_differing": {"value": sampled, "limit": 0}}
    return {"workload": workload, "seed": seed, "n": n,
            "correct": check.within(checks), "checks": checks,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chlbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(ROOT, args.workload, seed, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
