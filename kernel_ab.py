#!/usr/bin/env python3
"""Time the dense and the source-windowed relaxation kernels, the
(min, +) kernel and the label query of two or more checkouts of this
repository on one CUDA card, in turns (``--states`` keeps the named
measurements only).

    python3 kernel_ab.py [--states NAME,...] ROOT [ROOT ...]

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
- the source-windowed sweep ``ell_relax_windowed`` (its public API in
  every checkout) on two synthetic states made on the card from a seed:
  a uniform random graph shaped as ``chlbench``'s ``chl_urand22`` (n =
  4,194,304, Poisson(34) finite in-edges a row in an ELL of width 72,
  weights in [1, 2048), B = 4 and the card's window plan), a 4096 x 4096
  lattice (B = 4) and a graph of ``chl_kron22``'s hub shape (n =
  4,194,304, Poisson(12) finite in-edges a row in an ELL of width 32,
  and a hub tail of one row of 163,025 in-edges and five of 67,600 from
  sources anywhere: each hub's segment in each of the six windows is a
  tile alone, the largest ~27K edges), every tree alive and ``prop``
  finite at a set share of the sources (``windowed-urand-<per mille>``,
  ``windowed-grid-<per mille>``, ``windowed-kron-<per mille>``), and a
  graph of ``chl_kron22``'s segment lengths (``windowed-kronmid-<per
  mille>``): n = 4,194,304, every in-edge in the hub tail, and over the
  windows of the card's plan at B = 4 the segments kron22 has there
  (`KRONMID`: ≤ 8, 9-32, 33-128, 129-256, 257-512 and 513-2,048 edges
  and past the 2,048-edge buffer, each class with kron22's count and
  mean length), a row's segments in every window of one class, as a
  hub's are: the device time all of a call's device work covers, ms
  per call by CUDA events, the layout's tiles and gather gain, held
  equal to the dense sweep ``ell_relax`` on the same operands (kron's,
  with its hub tail passed to ``sweep_layout`` as ``tail=``, to the
  plain sweep of ELL + tail ``ell_sweep_plain(..., tail=)``: the dense
  kernel reads the ELL alone);
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
#: the windowed sweep's states: graph and finite-source share, per mille
WINDOWED = {f"windowed-{g}-{pm}": (g, pm) for g, pms in (
    ("urand", (1, 10, 100, 300, 500, 1000)), ("grid", (10, 1000)),
    ("kron", (10, 330, 1000)), ("kronmid", (10, 330, 1000))) for pm in pms}
#: the kron states' hub rows: in-edges of kron22's largest hub, then of
#: the next five
KRON_HUBS = (163025,) + (67600,) * 5
#: the kronmid state's segments: kron22's at B = 4 (PERF.md), as
#: (count, shortest, longest, mean edges) a length class, spread evenly
#: over the windows; a class's lengths are drawn as shortest +
#: (longest - shortest + 1) * u^k, u uniform, k set by the mean
KRONMID = ((6_674_737, 1, 8, 2.480), (1_176_759, 9, 32, 15.81),
           (447_504, 33, 128, 52.76), (157_765, 129, 256, 164.3),
           (27_729, 257, 512, 490.5), (25_401, 513, 2048, 884.0),
           (1_524, 2049, 27_334, 4951.0))
STATES = ("exactness", "road-mid", "random-mid", "dense", "query-exactness",
          "query-road", "query-random", "query-synthetic-256") + tuple(
              WINDOWED)


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


def kronmid_graph(dev, gen):
    """The kronmid state's adjacency (`KRONMID`): an ELL of one
    column, all padding, and every in-edge in the hub tail."""
    import torch
    from repro_torch.kernels.ell_relax.layout import window_plan
    from repro_torch.kernels.ell_relax.tail import EllTail
    n = 4194304
    W, nw, _ = window_plan(n, bb=4, device=dev)
    rows = torch.randperm(n, device=dev, generator=gen)
    seg_row, seg_len, at = [], [], 0
    for count, lo, hi, mean in KRONMID:
        count //= nw                                 # rows of the class
        k = (hi - lo + 1) / (mean - lo + 0.5) - 1
        u = torch.rand((count, nw), device=dev, generator=gen,
                       dtype=torch.float64)
        seg_len.append((lo + ((hi - lo + 1) * u ** k).long()).clamp(max=hi))
        seg_row.append(rows[at:at + count, None].expand(count, nw))
        at += count
    seg_row = torch.cat(seg_row).flatten()
    seg_len = torch.cat(seg_len).flatten()
    seg_win = torch.arange(nw, device=dev).repeat(seg_row.numel() // nw)
    seg = torch.repeat_interleave(torch.arange(seg_row.numel(), device=dev),
                                  seg_len)
    del seg_len
    width = torch.clamp(n - seg_win * W, max=W)
    src = seg_win[seg] * W + (torch.rand(seg.shape, device=dev,
                                         generator=gen) * width[seg]).long()
    dst, order = torch.sort(seg_row[seg], stable=True)
    del seg
    w = torch.randint(1, 2048, dst.shape, device=dev, generator=gen).float()
    tail = EllTail(dst.to(torch.int32), src[order].to(torch.int32), w)
    es = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    ew = torch.full((n, 1), torch.inf, device=dev)
    return es, ew, tail


def windowed_graph(dev, graph):
    """The windowed states' adjacency, made on the card from a seed:
    (ell_src, ell_w, tail), the tail None but for kron and kronmid."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(29)
    if graph == "kronmid":
        return kronmid_graph(dev, gen)
    if graph in ("urand", "kron"):
        n, deg, mean = (4194304, 72, 34.0) if graph == "urand" else (
            4194304, 32, 12.0)
        finite = torch.poisson(torch.full((n,), mean, device=dev),
                               generator=gen).clamp(max=deg)
        es = torch.randint(0, n, (n, deg), device=dev, generator=gen,
                           dtype=torch.int32)
        ok = torch.arange(deg, device=dev)[None, :] < finite[:, None]
    else:
        side = 4096
        i = torch.arange(side * side, device=dev)
        r, c = i // side, i % side
        ok = torch.stack([c > 0, c < side - 1, r > 0, r < side - 1], 1)
        es = torch.where(ok, torch.stack([i - 1, i + 1, i - side, i + side],
                                         1), 0).to(torch.int32)
    ew = torch.where(ok, torch.randint(1, 2048, ok.shape, device=dev,
                                       generator=gen).float(), torch.inf)
    tail = None
    if graph == "kron":
        from repro_torch.kernels.ell_relax.tail import EllTail
        hubs = torch.randperm(n, device=dev, generator=gen)[:len(KRON_HUBS)]
        dst = torch.repeat_interleave(
            hubs, torch.tensor(KRON_HUBS, device=dev)).sort().values
        tail = EllTail(
            dst.to(torch.int32),
            torch.randint(0, n, dst.shape, device=dev, generator=gen,
                          dtype=torch.int32),
            torch.randint(1, 2048, dst.shape, device=dev,
                          generator=gen).float())
    return es, ew, tail


def tail_kwargs(es, ew, tail) -> dict:
    """How this checkout's ``sweep_layout`` and ``ell_sweep_plain`` take
    a hub tail: as ``tail=``, or, in a checkout that bound the tail to
    the ELL tensors (``tail.attach``), bound here and no argument."""
    import inspect
    from repro_torch.kernels.ell_relax import sweep_layout
    if tail is None:
        return {}
    if "tail" in inspect.signature(sweep_layout).parameters:
        return {"tail": tail}
    from repro_torch.kernels.ell_relax.tail import attach
    attach(es, ew, tail)
    return {}


def windowed_operands(dev, n, per_mille):
    """B = 4 planes over n vertices, every tree alive, prop finite at
    ``per_mille`` of the sources: (dist, mrank, prop, alive, rank)."""
    import torch
    B = 4
    gen = torch.Generator(device=dev)
    gen.manual_seed(per_mille)
    dist = torch.randint(0, 1 << 20, (B, n), device=dev,
                         generator=gen).float()
    mrank = torch.randint(0, n, (B, n), device=dev, generator=gen,
                          dtype=torch.int32)
    prop = torch.where(torch.rand((B, n), device=dev, generator=gen)
                       < per_mille / 1000, dist, torch.inf)
    rank = torch.randperm(n, device=dev, generator=gen).to(torch.int32)
    alive = torch.ones(B, dtype=torch.bool, device=dev)
    return dist, mrank, prop, alive, rank


def measure_root(root: Path, only) -> dict:
    """One turn: every measurement of ``only`` on ``root``'s package."""
    # the checkout's package first: chip_smoke.py imports repro_torch
    # from beside it, which must then find this one already loaded
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    sys.path.insert(1, str(HERE))
    import chip_smoke as cs
    import torch
    assert Path(repro_torch.__file__).resolve().is_relative_to(
        root.resolve()), repro_torch.__file__
    from repro_torch.engine import rank_order
    from repro_torch.graphs import (betweenness_ranking, degree_ranking,
                                    device_arrays, grid_road,
                                    random_connected, scale_free)
    from repro_torch.index import BuildPlan, build
    from repro_torch.kernels import all_kernels, build_all
    from repro_torch.kernels.ell_relax import (clear_layout_cache, ell_relax,
                                               ell_relax_windowed,
                                               ell_sweep_plain, sweep_layout)
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
        if what not in only:
            continue
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
    for graph in ("urand", "grid", "kron", "kronmid"):
        wanted = [w for w, (g, _) in WINDOWED.items()
                  if g == graph and w in only]
        if not wanted:
            continue
        es, ew, tail = windowed_graph(dev, graph)
        kw = tail_kwargs(es, ew, tail)
        lay = sweep_layout(es, ew, bb=4, **kw)
        for what in wanted:
            dist, mrank, prop, alive, rank = windowed_operands(
                dev, es.shape[0], WINDOWED[what][1])
            call = lambda: ell_relax_windowed(         # noqa: E731
                dist, mrank, prop, alive, lay, rank)
            kd, km = call()
            dd, dm = (ell_sweep_plain(dist, mrank, prop, alive, es, ew,
                                      rank, **kw) if tail is not None else
                      ell_relax(dist, mrank, prop, alive, es, ew, rank))
            torch.cuda.synchronize()
            cs.require(torch.equal(kd, dd) and torch.equal(km, dm),
                       f"ell_relax_windowed != its plain or dense version"
                       f" at {what} in {root}")
            evs = cs.device_events(call, 10)
            out[what] = {"ms": cs.time_ms(call, reps=20),
                         "device_ms": (cs.covered(evs) / 1e3 / 10
                                       if evs else None),
                         "host_us": cs.host_us(call, 5, rounds=5),
                         "tiles": lay.segments.tile_segs.numel() - 1,
                         "gain": lay.gather_gain,
                         "digest": digest(kd, km)}
            del dist, mrank, prop, rank, kd, km, dd, dm
        del es, ew, tail, lay
        clear_layout_cache()
        torch.cuda.empty_cache()
    if "dense" not in only and not any(w.startswith("query-")
                                       for w in only):
        return out
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
        if what not in only:
            continue
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
        print(json.dumps(measure_root(Path(sys.argv[2]),
                                      sys.argv[3].split(","))), flush=True)
        return 0
    args = sys.argv[1:]
    only = STATES
    if args[:1] == ["--states"]:
        only = tuple(args[1].split(","))
        if "query-exactness" in only and "exactness" not in only:
            only += ("exactness",)       # its table is the build's
        args = args[2:]
        unknown = set(only) - set(STATES)
        if unknown:
            print(f"kernel_ab: no such state {sorted(unknown)}",
                  file=sys.stderr)
            return 2
    import torch
    if not torch.cuda.is_available() or not args:
        print("kernel_ab: needs a CUDA card and at least one checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    runs = []
    for root in args:
        res = subprocess.run([sys.executable, __file__, "--measure", root,
                              ",".join(only)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        r = runs[-1]
        for what in only:
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
            if what in WINDOWED:
                extra += f"; {m['tiles']} tiles, gather gain {m['gain']:.4f}"
            print(f"{root} {what}: {m['ms']:.4f} ms per call (events), "
                  f"device {cs.fmt_ms(m['device_ms'])}{extra}; outputs "
                  f"{m['digest']}", flush=True)
    for what in only:
        cs.require(len({r[what]["digest"] for r in runs}) == 1,
                   f"{what}: the checkouts' outputs differ")
    card = cs.card_line()
    print("outputs identical across checkouts")
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
