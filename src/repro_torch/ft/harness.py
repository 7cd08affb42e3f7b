"""Subprocess crash-kill harness.

The recovery guarantees in this repo are pinned by *really killing*
processes, not by raising exceptions the code under test could
accidentally catch: a child process runs the production code path with
a :class:`~repro_torch.ft.inject.FaultPlan` delivered through the
``REPRO_FAULT_PLAN`` environment variable, a ``Fault("crash",
hard=True)`` drops it with ``os._exit(FAULT_EXIT_CODE)`` at the named
site (no unwinding, no atexit, no flushing — the moral equivalent of
``kill -9``), and the parent then resumes/reloads and asserts the
recovered labels are **bit-identical** to an uninterrupted run.

Bit-identity is asserted over the *loaded arrays*, not the artifact
bytes: ``.npz`` members embed zip timestamps, so byte-comparing files
across runs is meaningless while array-comparing them is exact.

Used by ``tests/test_torch_ft.py`` and ``chip_smoke.py``'s crash
matrix.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.ft.inject import ENV_PLAN, FAULT_EXIT_CODE, FaultPlan
from repro_torch.index.store import shard_filename


def run_child(args: List[str], *, plan: Optional[FaultPlan] = None,
              env: Optional[Dict[str, str]] = None,
              timeout: float = 900.0) -> subprocess.CompletedProcess:
    """Run ``python <args...>`` with ``plan`` installed via the
    environment (inherits the parent's env, so ``PYTHONPATH`` et al.
    carry over)."""
    e = dict(os.environ)
    if env:
        e.update(env)
    if plan is not None:
        e[ENV_PLAN] = plan.to_json()
    else:
        e.pop(ENV_PLAN, None)
    return subprocess.run([sys.executable, *args], env=e,
                          capture_output=True, text=True,
                          timeout=timeout)


def _tail(text: str, lines: int = 20) -> str:
    return "\n".join(text.strip().splitlines()[-lines:])


def assert_child_ok(proc: subprocess.CompletedProcess) -> None:
    if proc.returncode != 0:
        raise AssertionError(
            f"child exited {proc.returncode}, expected 0\n"
            f"stdout:\n{_tail(proc.stdout)}\n"
            f"stderr:\n{_tail(proc.stderr)}")


def assert_child_killed(proc: subprocess.CompletedProcess) -> None:
    """The child must have died at the injected fault site — exit code
    ``FAULT_EXIT_CODE``, not a clean exit (fault never fired) and not
    a generic failure (died somewhere else)."""
    if proc.returncode != FAULT_EXIT_CODE:
        raise AssertionError(
            f"child exited {proc.returncode}, expected injected-crash "
            f"exit {FAULT_EXIT_CODE}\n"
            f"stdout:\n{_tail(proc.stdout)}\n"
            f"stderr:\n{_tail(proc.stderr)}")


def index_arrays(directory: str) -> Dict[str, np.ndarray]:
    """Every array of a saved artifact (v2 layout and later), keyed ``rank`` /
    ``shard_<k>/<name>`` — the bit-identity comparison surface."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    out = {"rank": np.load(os.path.join(directory, "rank.npy"))}
    for k in range(int(manifest["store"]["shards"])):
        with np.load(os.path.join(directory, shard_filename(k))) as z:
            for name in z.files:
                out[f"shard_{k}/{name}"] = z[name]
    return out


def assert_index_bit_identical(got_dir: str, want_dir: str) -> None:
    got = index_arrays(got_dir)
    want = index_arrays(want_dir)
    if set(got) != set(want):
        raise AssertionError(
            f"artifact array sets differ: only-got="
            f"{sorted(set(got) - set(want))} only-want="
            f"{sorted(set(want) - set(got))}")
    for key in sorted(got):
        if not np.array_equal(got[key], want[key]):
            raise AssertionError(
                f"{key} differs between {got_dir} and {want_dir} — "
                "recovery is NOT bit-identical")
