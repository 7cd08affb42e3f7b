#!/usr/bin/env python3
"""Time the dense relaxation kernel, the (min, +) kernel and the label
query of two or more checkouts of this repository on one CUDA card, in
turns.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout (for example a ``git archive`` of the parent
commit unpacked under the git-ignored ``build/``, and ``.``); give them
in the order to run, e.g. ``build/parent . . build/parent``. Each turn
is a fresh process that imports that checkout's ``repro_torch`` and
measures, with ``chip_smoke.py``'s timers:

- ``ell_relax`` on the exactness state (grid_road(64, 64), B = 16,
  after 32 sweeps) and on the two mid-size states of ``chip_smoke.py``
  (grid_road(896, 896) and random_connected(786,432), B = 4): ms per
  call by CUDA events, the kernel's device ms from ``torch.profiler``
  and the wrapper's host µs per call (the median of 9 loops);
- the whole exactness build (batch 16) on the card: its wall, whose
  sweeps are paced by the host;
- dense-block PLaNT (scale_free(32,768), 64 roots): the fixpoint's wall
  and launches, then ``minplus`` at B = 64, K = N = 32,768;
- the serving entry point ``query_table(table, u, v)`` (its public API
  in every checkout) on 65,536 random pairs over four tables: the
  exactness build's (L = 288), a synthetic road-like table (n =
  16,777,216, L = count = 8, every row the same 8 hubs in the same
  order, as one superstep of 8 trees leaves the road table), a
  synthetic random-like one (n = 4,194,304, L = 32, the same 8 hubs a
  row and padding past them, as the random superstep leaves its
  table) and a synthetic full table (L = count = 256, hubs from a
  shared pool):
  the device time all of a call's device work covers (gathers and
  kernel alike), the device kernels a call runs, ms per call by CUDA
  events and the host µs per call. The synthetic tables are made on
  the card from a seed by this script, so every checkout gets the same.

Every output is held equal to that checkout's plain version, and the
outputs' digests must agree across checkouts. Prints one line per
measurement and the card.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
STATES = ("exactness", "road-mid", "random-mid", "dense", "query-exactness",
          "query-road", "query-random", "query-synthetic-256")


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def relax_state(dev, g, rank, batch, sweeps):
    import torch
    from repro_torch.engine import rank_order
    from repro_torch.graphs import device_arrays
    from repro_torch.sssp import batched_sssp_maxrank
    a = device_arrays(g, rank, dev)
    roots = torch.as_tensor(rank_order(rank)[:batch], device=dev).long()
    st = batched_sssp_maxrank(a.ell_src, a.ell_w, a.rank, roots,
                              max_sweeps=sweeps)
    alive = torch.ones(st.dist.shape[0], dtype=torch.bool, device=dev)
    return (st.dist, st.mrank, st.dist, alive, a.ell_src, a.ell_w, a.rank)


def measure_root(root: Path) -> dict:
    """One turn: every measurement on ``root``'s package."""
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(root / "src"))
    import torch
    import repro_torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        root.resolve()), repro_torch.__file__
    from repro_torch.engine import rank_order
    from repro_torch.graphs import (betweenness_ranking, degree_ranking,
                                    device_arrays, grid_road,
                                    random_connected, scale_free)
    from repro_torch.index import BuildPlan, build
    from repro_torch.kernels import all_kernels, build_all
    from repro_torch.kernels.ell_relax import ell_relax, ell_sweep_plain
    from repro_torch.kernels.label_query import query_table
    from repro_torch.kernels.minplus import (dense_weights, minplus,
                                             plant_fixpoint_dense)
    dev = torch.device("cuda")
    build_all(all_kernels())
    out = {"root": str(root)}
    states = {
        "exactness": lambda: (lambda g: (g, betweenness_ranking(
            g, samples=12), cs.EXACT_BATCH, 32, 200))(
                grid_road(64, 64, seed=7)),
        "road-mid": lambda: (lambda g: (g, degree_ranking(g), 4, 128, 50))(
            grid_road(cs.MID_ROAD_SIDE, cs.MID_ROAD_SIDE)),
        "random-mid": lambda: (lambda g: (g, degree_ranking(g), 4, 8, 50))(
            random_connected(cs.MID_RANDOM_N,
                             extra_edges=cs.MID_RANDOM_N, seed=0)),
    }
    for what, make in states.items():
        g, rank, batch, sweeps, reps = make()
        ops = relax_state(dev, g, rank, batch, sweeps)
        kd, km = ell_relax(*ops)
        pd, pm = ell_sweep_plain(*ops)
        torch.cuda.synchronize()
        cs.require(torch.equal(kd, pd) and torch.equal(km, pm),
                   f"ell_relax != plain at {what} in {root}")
        kern = lambda: ell_relax(*ops)              # noqa: E731
        out[what] = {"ms": cs.time_ms(kern, reps=reps),
                     "device_ms": cs.device_ms(kern, reps, "ell_relax"),
                     "host_us": cs.host_us(kern, reps, rounds=9),
                     "digest": digest(kd, km)}
        del ops, kd, km, pd, pm
        if what == "exactness":
            # the whole build, host-paced at this size
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = build(g, rank, BuildPlan(algo="plant", batch=batch),
                        device=dev)
            torch.cuda.synchronize()
            out[what]["build_s"] = time.perf_counter() - t0
            out[what]["sweeps"] = sum(r.sweeps
                                      for r in idx.report.supersteps)
            out[what]["digest"] += "/" + digest(*idx.table)
            exact_table = idx.table
    g = scale_free(cs.DENSE_N, attach=2, seed=0)
    rank = degree_ranking(g)
    a = device_arrays(g, rank, dev)
    roots = torch.as_tensor(rank_order(rank)[:cs.DENSE_ROOTS], device=dev)
    w = dense_weights(g, dev)
    for k in all_kernels():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dist, mrank, emit = plant_fixpoint_dense(w, a.rank, roots)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = next(k.launches for k in all_kernels()
                    if k.name == "minplus")
    kern = lambda: minplus(dist, mrank, w)          # noqa: E731
    kd, km = kern()
    out["dense"] = {"fixpoint_s": wall, "launches": launches,
                    "ms": cs.time_ms(kern, reps=5, warmup=1),
                    "device_ms": cs.device_ms(kern, 3, "minplus"),
                    "digest": digest(dist, mrank, emit, kd, km)}
    del w, dist, mrank, emit, kd, km
    torch.cuda.empty_cache()
    tables = {
        "query-exactness": lambda: exact_table,
        "query-road": lambda: cs.synthetic_table(
            dev, cs.ROAD_ROWS * cs.ROAD_COLS, 8, cs.ROAD_ROWS * cs.ROAD_COLS,
            seed=8, same_row=True),
        "query-random": lambda: cs.synthetic_table(
            dev, cs.RANDOM_N, cs.RANDOM_CAP, cs.RANDOM_N, seed=32,
            same_row=True, count=cs.RANDOM_TREES),
        "query-synthetic-256": lambda: cs.synthetic_table(
            dev, cs.SYNTH_N, cs.SYNTH_L, cs.SYNTH_POOL, seed=256),
    }
    for what, make in tables.items():
        table = make()
        u, v = cs.random_pairs(dev, table.n, 13)
        call = lambda: query_table(table, u, v)     # noqa: E731
        d, h = call()
        pd, ph = cs.query_pairs_in_chunks(table, u, v)
        torch.cuda.synchronize()
        cs.require(torch.equal(d, pd) and torch.equal(h, ph),
                   f"query_table != plain at {what} in {root}")
        reps = 20 if table.cap > 32 else 100
        evs = cs.device_events(call, reps)
        out[what] = {"ms": cs.time_ms(call, reps=reps),
                     "device_ms": (cs.covered(evs) / 1e3 / reps
                                   if evs else None),
                     "kernels_per_call": len(evs) / reps,
                     "host_us": cs.host_us(call, reps, rounds=9),
                     "digest": digest(d, h)}
        del table, d, h, pd, ph
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure_root(Path(sys.argv[2]))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(sys.argv) < 2:
        print("kernel_ab: needs a CUDA card and at least one checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    runs = []
    for root in sys.argv[1:]:
        res = subprocess.run([sys.executable, __file__, "--measure", root],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        for what in STATES:
            m = r[what]
            extra = (f", fixpoint {m['fixpoint_s']:.3f} s, "
                     f"{m['launches']} launches" if what == "dense" else
                     f", host {m['host_us']:.1f} us per call")
            if what.startswith("query-"):
                extra += (f", {m['kernels_per_call']:g} device kernels a "
                          "call")
            if what == "exactness":
                extra += (f"; the build {m['build_s']:.3f} s, "
                          f"{m['sweeps']} sweeps")
            print(f"{root} {what}: {m['ms']:.4f} ms per call (events), "
                  f"device {cs.fmt_ms(m['device_ms'])}{extra}; outputs "
                  f"{m['digest']}", flush=True)
    for what in STATES:
        cs.require(len({r[what]["digest"] for r in runs}) == 1,
                   f"{what}: the checkouts' outputs differ")
    card = cs.card_line()
    print("outputs identical across checkouts")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
