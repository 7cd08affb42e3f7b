"""Run one cell of the benchmark once and print its result line.

    python3 chlbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (`src/repro_torch`)
on a machine with as many CUDA cards as the cell asks for. The last line
of standard output is the result (JSON); the checks that decide
``correct`` are the last lines of standard error. Exits non-zero, with no
result, without CUDA or enough cards, when the port is missing, or when
the run loaded JAX or the JAX package.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# caches that a library may write go inside the checkout, at fixed paths
# (the port's own kernels build into src/repro_torch/kernels/_build/)
os.environ["TRITON_CACHE_DIR"] = str(ROOT / ".chlbench" / "triton")
os.environ["CUDA_CACHE_PATH"] = str(ROOT / ".chlbench" / "nv")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else \
        f"nvidia-smi unavailable (rc={out.returncode})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from chlbench import bench

    spec = bench.load_spec(ROOT)
    cell, _ = bench.find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("chlbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"chlbench: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = bench.run_cell(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda", t0=T0,
                            spec=spec)
    bad = bench.forbidden_modules(list(sys.modules))
    if bad:
        print(f"chlbench: the run loaded {bad}: the benchmark measures the "
              "port alone", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    bench.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
