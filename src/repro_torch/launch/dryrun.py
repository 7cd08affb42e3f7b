"""Multi-pod dry-run driver (one cell per invocation, or --all).

For every (architecture x input shape x mesh) cell, on a fake world of
512 ranks (`launch.mesh.fake_world`) in which this process is rank 0:

    args = make_cell(...)                # fake DTensors, nothing allocated
    with FakeTensorMode, StepCounter:    # rank 0's local ops
        step(*args)                      # the DTensor program, traced

The record (appended to a JSONL file) has the reference's keys where
PyTorch has a counterpart:

- ``memory`` (rank 0): ``argument_size_in_bytes`` the local bytes of the
  step's arguments; ``output_size_in_bytes`` those of its results (a
  storage counted once: the train step's parameters are updated in
  place); ``temp_size_in_bytes`` the peak of the live bytes the step
  allocates (its arguments excluded), by `roofline.analysis.StepCounter`'s
  tracker of fake storages (a storage counts from the op that makes it
  until it is freed);
- ``cost``: ``flops`` what rank 0 computes (the local ops,
  ``torch.utils.flop_counter``'s formulas), ``bytes accessed`` the sum
  of each local op's operand and result bytes (views and collectives
  excepted), the eager counterpart of XLA's per-op count;
- ``lower_s`` the trace's seconds; ``compile_s`` 0.0 (nothing compiles);
- ``roofline`` (`roofline.analysis.analyze`, H100 constants), ``params``,
  ``active_params`` as in the reference; ``fallbacks`` the ops that
  `parallel.dtensor.ReplicateFallback` re-ran with gathered operands.

A CHL cell (``chl_road``/``chl_scalefree`` x ``plant``/``dgll``) cannot
be traced on fake tensors: the superstep's fixpoint and overflow tests
read the host. Its record is built from closed forms at full size:
``argument_size_in_bytes`` is one node's operands built on the ``meta``
device by the build's own functions (`init_dist_state`, `NodeGraph`,
the queue slices), ``output_size_in_bytes`` its table and four scalars,
the collectives are those of the shapes the superstep passes to
`parallel.collectives`, ``cost`` is the reference's relaxation-work
formula per node (``bytes accessed``: each sweep reads the node's ELL
once and reads and writes its [B, n] distance and rank planes once).
One real superstep on the config's SMOKE graph over ``--check-q``
logical nodes checks both closed forms against the tensors and
`parallel.collectives.BYTES`, and that PLaNT makes no collective call
and DGLL at least one.

Usage:
    python -m repro_torch.launch.dryrun --arch smollm_360m \
        --shape train_4k --mesh single --out results/dryrun.jsonl
    python -m repro_torch.launch.dryrun --all --out results/dryrun.jsonl
    python -m repro_torch.launch.dryrun --arch chl_road --shape plant \
        --mesh pod

``--device`` (default: the card; raises without CUDA) is the device
type of the meshes and the fake tensors; ``--device cpu`` runs on the
CPU.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import base as cfgbase
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import (fake_world, make_flat_mesh,
                                     make_production_mesh)
from repro_torch.models import layers as ly
from repro_torch.models import model as mdl
from repro_torch.parallel import dtensor, logical, sharding as shd
from repro_torch.roofline import analysis as ra
from repro_torch.train import trainer

CHL_SHAPES = ("plant", "dgll")
RULES = ("fsdp", "tp", "sp", "fsdp_opt")


def _rules(name: str):
    return {"fsdp": shd.FSDP_RULES, "tp": shd.TP_RULES,
            "sp": shd.SP_RULES, "fsdp_opt": shd.FSDP_OPT_RULES}[name]


def _tensors(tree):
    """The tensors of a step's argument or result tree (a module's
    parameters, dicts, tuples)."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def local_bytes(tree) -> int:
    """Rank 0's bytes of the tensors of ``tree``, a storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        loc = _local(t)
        st = loc.untyped_storage()
        if id(st) in seen:
            continue
        seen.add(id(st))
        total += st.nbytes()
    return total


def run_lm_cell(arch: str, shape_name: str, multi_pod: bool,
                rules_name: str = "fsdp", variant: str = "baseline",
                dm_shape=None, device: DeviceLike = None, *,
                mesh=None, smoke: bool = False,
                n_layers: Optional[int] = None) -> dict:
    """One LM cell on the production mesh (or ``mesh``), in an open
    process group; ``n_layers`` cuts the model's depth."""
    rules = _rules(rules_name)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, dm_shape=dm_shape,
                                    device=device)
    chips = mesh.size()
    cell = sp.make_cell(arch, shape_name, mesh, rules=rules,
                        variant=variant, smoke=smoke, n_layers=n_layers)
    step = sp.cell_step_fn(cell, mesh, rules=rules,
                           accum_steps=sp.variant_accum(variant))
    counter = ra.StepCounter()
    counter.exclude([_local(t) for t in _tensors(cell.args)])
    dtensor.reset_fallbacks()
    t0 = time.time()
    # the model caches its RoPE frequencies a device: none may cross
    # between fake and real tensors
    ly._inv_freqs.cache_clear()
    try:
        with cell.fake_mode, counter:
            out = step(*cell.args)
    finally:
        ly._inv_freqs.cache_clear()
    t_lower = time.time() - t0
    arg_bytes = local_bytes(cell.args)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": local_bytes(out),
           "temp_size_in_bytes": counter.peak_bytes}
    cost = {"flops": counter.flops, "bytes accessed": counter.bytes}
    print(mem)
    print(cost)
    mf = ra.model_flops_estimate(cell.config, cell.shape)
    roof = ra.analyze(counter.flops, counter.bytes, counter.coll,
                      chips=chips, model_flops_total=mf)
    names = tuple(mesh.mesh_dim_names)
    mesh_name = "x".join(str(mesh.size(i)) for i in range(len(names)))
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "rules": rules_name, "variant": variant,
        "chips": chips, "status": "ok",
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory": mem, "cost": cost,
        "roofline": roof.to_dict(),
        "params": cell.config.param_count(),
        "active_params": cell.config.active_param_count(),
        "fallbacks": dict(dtensor.FALLBACKS),
        **({} if n_layers is None else {"reduced": {"n_layers": n_layers}}),
    }


def spec_arg_bytes(cfg, kind: str, mesh, rules, B: int, S: int) -> int:
    """Rank 0's argument bytes of a cell (``kind`` train, prefill or
    decode; the baseline AdamW state, f32 moments) from the specs alone:
    the parameters' (`resolve_params`' layout), the batch's and the
    decode state's local shapes. ``mesh`` may be any object with a
    ``shape`` mapping."""
    def local(shape, spec, itemsize):
        return int(np.prod(logical.local_shape(shape, spec, mesh),
                           dtype=np.int64)) * itemsize

    model = mdl.abstract_params(cfg)
    axes = model.param_axes()
    params = sum(local(p.shape, logical.spec_for(axes[k], rules, mesh,
                                                 p.shape), p.element_size())
                 for k, p in model.named_parameters())
    total = params

    def batch_bytes(tree):
        return sum(local(x.shape, shd.batch_spec(mesh, rules, x.dim(),
                                                 x.shape), x.element_size())
                   for x in tree.values())

    if kind == "train":
        # params, mu, nu (f32 state), the step and the batch
        total += 2 * params + 4
        return total + batch_bytes(sp._batch_specs(cfg, B, S, "train"))
    st_specs, st = trainer.serve_state_specs(cfg, mesh, rules, B, S)
    total += sum(local(t.shape, st_specs[k][n], t.element_size())
                 for k, v in st.items() if k != "pos"
                 for n, t in v.items())
    if kind == "prefill":
        return total + batch_bytes(sp._batch_specs(cfg, B, S, "prefill"))
    total += batch_bytes({"token": torch.empty((B, 1), dtype=torch.int32,
                                               device="meta")})
    mem = sp._mem_specs(cfg, B)
    return total + (0 if mem is None else batch_bytes({"mem": mem}))


# ------------------------------------------------------------------ CHL

def chl_arg_bytes(n: int, deg: int, T: int, cap: int, hc_cap: int = 1
                  ) -> int:
    """One node's superstep operands: its ``[n, cap]`` table (i32 hubs,
    f32 distances, i32 counts), the ``[n, hc_cap]`` common table, the
    graph (i32 ``ell_src``, f32 ``ell_w`` ``[n, deg]``, i32 rank) and
    its queue slice (i32 roots, bool valid ``[T]``)."""
    return (n * cap * 8 + n * 4) + (n * hc_cap * 8 + n * 4) \
        + (n * deg * 8 + n * 4) + T * 5


def chl_out_bytes(n: int, cap: int) -> int:
    """One node's superstep results: its table and four scalars (i32
    labels and explored, bool overflow flags)."""
    return n * cap * 8 + n * 4 + 4 + 4 + 1 + 1


def chl_collectives(q: int, n: int, T: int, plant: bool, compact: int = 0
                    ) -> Dict[str, list]:
    """``{collectives function: [bytes of one node's piece, ...]}`` of a
    superstep that needs no fallback: none for PLaNT; DGLL gathers the
    i32 roots ``[T]``, the bool emissions and f32 distances ``[T, n]``
    (``compact = K``: i64 ids, bool valid, f32 distances ``[T, K]``)
    and takes `pmax` of the i32 best-witness ranks ``[q·T, n]`` (``[q,
    T, K]``)."""
    if plant:
        return {}
    if compact > 0:
        K = min(compact, n)
        return {"all_gather": [T * 4, T * K * 8, T * K, T * K * 4],
                "pmax": [q * T * K * 4]}
    return {"all_gather": [T * 4, T * n, T * n * 4],
            "pmax": [q * T * n * 4]}


def collectives_bytes(q: int, pieces: Dict[str, list]) -> Dict[str, int]:
    """`parallel.collectives.BYTES` of ``pieces``: each node's piece to
    the q - 1 others."""
    return {k: sum((q - 1) * q * b for b in v) for k, v in pieces.items()}


def chl_collective_stats(q: int, pieces: Dict[str, list]
                         ) -> ra.CollectiveStats:
    """The ring model of ``pieces`` on a group of ``q`` nodes: a gather's
    result is q pieces, `pmax` is an all-reduce of one piece."""
    st = ra.CollectiveStats()
    for b in pieces.get("all_gather", []):
        ra.record_collective(st, "all-gather", q * b, q)
    for b in pieces.get("pmax", []):
        ra.record_collective(st, "all-reduce", b, q)
    return st


def _smoke_graph(arch: str, n: int):
    from repro_torch.graphs import generators as gen
    if "road" in arch:
        side = int(round(n ** 0.5))
        return gen.grid_road(side, n // side, seed=0)
    return gen.scale_free(n, attach=2, seed=0)


def check_chl_superstep(arch: str, plant: bool, compact: int, q: int,
                        device: DeviceLike) -> dict:
    """One real superstep of the config's SMOKE graph on ``q`` logical
    nodes: asserts the closed forms (one node's operand bytes, the
    collectives' bytes) and PLaNT's silence / DGLL's exchange. Returns
    the collective calls."""
    from repro_torch.core.dgll import (assign_roots, dgll_superstep_fn,
                                       init_dist_state)
    from repro_torch.engine.dist import node_graph
    from repro_torch.graphs.ranking import degree_ranking
    from repro_torch.parallel import collectives as coll
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    sc = mod.SMOKE
    g = _smoke_graph(arch, sc.n)
    rank = degree_ranking(g)
    mesh = make_flat_mesh(q, device)
    graph = mesh.replicate(lambda d: node_graph(g, rank, d, sc.batch))
    st = init_dist_state(mesh, g.n, sc.cap, 1)
    T = sc.trees_per_node
    roots = assign_roots(rank, q)[:, :T]
    valid = roots >= 0
    deg = graph[0].ell_src.shape[1]
    got = sum(t.numel() * t.element_size() for t in (
        *st.table[0], *st.hc[0], *graph[0][:3]))
    got += roots[0].astype(np.int32).nbytes + valid[0].nbytes
    want = chl_arg_bytes(g.n, deg, T, sc.cap)
    assert got == want, f"one node's operands: {got} B, closed form {want}"
    fn = dgll_superstep_fn(mesh, g.n, batch=sc.batch, use_hc=False,
                           plant_trees=plant, compact=compact)
    coll.reset_counts()
    out = fn(st.table, st.hc, graph, roots, valid)
    calls = dict(coll.COUNTS)
    if plant:
        assert coll.total_calls() == 0, (
            f"PLaNT superstep must be collective-free, got {calls}")
    else:
        assert coll.total_calls() > 0, "DGLL superstep must exchange labels"
        ovf = any(bool(x) for x in out.compact_overflow)
        if not ovf:
            want = collectives_bytes(q, chl_collectives(q, g.n, T, plant,
                                                        compact))
            got = {k: v for k, v in coll.BYTES.items() if v}
            assert got == want, f"collective bytes {got}, closed form {want}"
    return calls


def run_chl_cell(arch: str, shape_name: str, multi_pod: bool,
                 variant: str = "baseline", device: DeviceLike = None, *,
                 check_q: int = 8) -> dict:
    """The paper's workload: one distributed superstep (PLaNT: must be
    collective-free; DGLL: gathers and a max-reduce) per node of the
    full node set (512 = 2 pods x 256), as closed forms at full size,
    checked by a real superstep at the SMOKE size on ``check_q``
    nodes."""
    from repro_torch.core.dgll import NodeGraph, init_dist_state
    from repro_torch.parallel.mesh import NodeMesh
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    ccfg = mod.CONFIG
    q = 512 if multi_pod else 256
    n, T, B, deg = ccfg.n, ccfg.trees_per_node, ccfg.batch, ccfg.max_deg
    plant = shape_name == "plant"
    compact = ccfg.compact if variant == "opt" and not plant else 0
    t0 = time.time()
    # one node's operands at full size, on the meta device
    meta = NodeMesh([torch.device("meta")])
    st = init_dist_state(meta, n, ccfg.cap, 1)
    ng = NodeGraph(torch.empty((n, deg), dtype=torch.int32, device="meta"),
                   torch.empty((n, deg), dtype=torch.float32,
                               device="meta"),
                   torch.empty((n,), dtype=torch.int32, device="meta"),
                   None)
    roots = torch.empty((T,), dtype=torch.int32, device="meta")
    valid = torch.empty((T,), dtype=torch.bool, device="meta")
    arg_bytes = sum(t.numel() * t.element_size() for t in (
        *st.table[0], *st.hc[0], *ng[:3], roots, valid))
    if arg_bytes != chl_arg_bytes(n, deg, T, ccfg.cap):
        raise AssertionError("closed form of the operands disagrees with "
                             "the build's tensors")
    pieces = chl_collectives(q, n, T, plant, compact)
    coll = chl_collective_stats(q, pieces)
    t_lower = time.time() - t0
    calls = check_chl_superstep(arch, plant, compact, min(q, check_q),
                                device)
    # relaxation (min,+) work ~ 2 flops/edge/sweep x diameter sweeps
    sweeps = 64 if "road" in arch else 16
    mf = 2.0 * n * deg * q * B * sweeps
    flops = mf / q
    hbm = sweeps * (n * deg * 8 + 2 * B * n * 8)
    roof = ra.analyze(flops, hbm, coll, chips=q, model_flops_total=mf)
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": chl_out_bytes(n, ccfg.cap)}
    print(mem)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": f"flat{q}" + ("(2pods)" if multi_pod else ""),
        "variant": variant,
        "chips": q, "status": "ok",
        "lower_s": round(t_lower, 2), "compile_s": 0.0,
        "memory": mem,
        "cost": {"flops": flops, "bytes accessed": hbm},
        "roofline": roof.to_dict(),
        "collective_free": plant and not coll.counts,
        "check": {"q": min(q, check_q), "collective_calls": calls},
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules: str = "fsdp", variant: str = "baseline",
             dm_shape=None, device: DeviceLike = None,
             n_layers: Optional[int] = None) -> dict:
    if arch.startswith("chl_"):
        return run_chl_cell(arch, shape_name, multi_pod, variant=variant,
                            device=device)
    return run_lm_cell(arch, shape_name, multi_pod, rules, variant,
                       dm_shape, device, n_layers=n_layers)


def all_cells():
    for arch in cfgbase.lm_arch_ids():
        spec = cfgbase.get(arch)
        for shape in cfgbase.SHAPES:
            yield arch, shape.name, spec.skip_reason(shape.name)
    for arch in ("chl_road", "chl_scalefree"):
        for shape in CHL_SHAPES:
            yield arch, shape, None


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "pod", "both"),
                    default="both")
    ap.add_argument("--rules", default="fsdp", choices=RULES)
    ap.add_argument("--variant", default="baseline",
                    choices=tuple(sp.VARIANTS))
    ap.add_argument("--dm-shape", default=None,
                    help="data x model per pod, e.g. 32x8")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut an LM's depth to this many layers (whole "
                         "groups of its layer pattern)")
    ap.add_argument("--device", default=None,
                    help="device type of the meshes and fake tensors "
                         "(default: the card; 'cpu' runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    meshes = {"single": [False], "pod": [True],
              "both": [False, True]}[args.mesh]
    todo = (list(all_cells()) if args.all
            else [(args.arch, args.shape, None)])
    dm = (tuple(int(x) for x in args.dm_shape.split("x"))
          if args.dm_shape else None)

    records = []
    with open(args.out, "a") as f, fake_world():
        for arch, shape, skip in todo:
            for multi_pod in meshes:
                mesh_name = "2x16x16" if multi_pod else "16x16"
                tag = f"{arch} × {shape} × {mesh_name}"
                if skip:
                    rec = {"arch": arch, "shape": shape,
                           "mesh": mesh_name, "status": "skip",
                           "reason": skip}
                    print(f"[skip] {tag}: {skip}")
                else:
                    print(f"[run ] {tag}")
                    try:
                        rec = run_cell(arch, shape, multi_pod, args.rules,
                                       args.variant, dm, device,
                                       args.n_layers)
                        r = rec["roofline"]
                        print(f"[ok  ] {tag} lower={rec['lower_s']}s"
                              f" bottleneck={r['bottleneck']}")
                    except cfgbase.SkipCell as e:
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name, "status": "skip",
                               "reason": str(e)}
                    except Exception as e:
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name, "status": "error",
                               "error": f"{type(e).__name__}: {e}"}
                f.write(json.dumps(rec) + "\n")
                f.flush()
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
