"""Distributed policies — DGLL / Hybrid / PLaNT-dist over a node mesh.

One policy covers the whole §5 family: PLaNT supersteps while
``Ψ <= Ψ_th``, DGLL supersteps after (``psi_threshold=inf``: pure
PLaNT, ``0``: pure DGLL), the optional Common-Label-Table prologue
(§5.3) and the §Perf-2 compact-broadcast fallback. The superstep
itself (`repro_torch.core.dgll.dgll_superstep_fn`) stays in ``core``;
this module drives it: scheduling, growth, the Ψ switch, node-loss
recovery and checkpointing belong to the engine.

Every node sweeps through the source-bucketed layout built once per
graph and device here (`repro_torch.sssp.relax.ell_layout`): past half
the card's L2 the windowed kernel runs inside the node steps, as in
the single-host policies.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import labels as lbl
from repro_torch.core.dgll import NodeGraph, assign_roots, dgll_superstep_fn
from repro_torch.core.labels import LabelTable
from repro_torch.core.plant import plant_batch
from repro_torch.engine.policies import Policy, StepOutcome, build_fingerprint
from repro_torch.engine.records import make_record, pack_stats
from repro_torch.engine.scheduler import (QueueSchedule, Step, pad_step,
                                          rank_order)
from repro_torch.ft.elastic import HeartbeatMonitor, lost_roots
from repro_torch.graphs.graph import device_arrays
from repro_torch.parallel import collectives as coll
from repro_torch.sssp.relax import ell_layout


def auto_psi_threshold(q: int, gamma: float = 12.0) -> float:
    """Ψ_th as a function of cluster size (the paper's §8 future work:
    make the PLaNT -> DGLL switching point a function of q and Ψ).

    A PLaNTed tree costs Ψ explored vertices per label with zero
    communication; a DGLL tree costs O(1) pruned relaxations per label
    plus a broadcast and cleaning share that grows with q. Equating
    the two gives a switch point linear in q: Ψ_th = γ·q."""
    return gamma * max(1, q)


def node_graph(g, rank: np.ndarray, device, batch: int):
    """The graph operands of the nodes on ``device``: the adjacency,
    the rank and the sweeps' source-bucketed layout (None where one
    window covers the graph)."""
    a = device_arrays(g, rank, device)
    return NodeGraph(a.ell_src, a.ell_w, a.rank,
                     ell_layout(a.ell_src, a.ell_w, batch=batch))


def build_common_table(graph: NodeGraph, eta_roots: np.ndarray,
                       hc_cap: int) -> LabelTable:
    """The Common Label Table from the top-η PLaNTed trees, on the
    device of ``graph`` (a node's operands, `node_graph`).

    Recomputed on every device of the mesh instead of broadcast: PLaNT
    trees depend on nothing, so replication costs zero communication."""
    dev = graph.ell_src.device
    hc = lbl.empty(graph.ell_src.shape[0], hc_cap, dev)
    roots = torch.as_tensor(np.asarray(eta_roots).astype(np.int64),
                            device=dev)
    valid = torch.ones(len(eta_roots), dtype=torch.bool, device=dev)
    tb = plant_batch(graph.ell_src, graph.ell_w, graph.rank, roots, valid,
                     layout=graph.layout)
    hc, ovf = lbl.insert_batch(hc, roots, tb.emit, tb.dist)
    if bool(ovf):
        raise lbl.LabelOverflowError(hc_cap, "common label table")
    return hc


def _fetch_mesh_stats(out) -> Tuple[int, int, bool, bool]:
    """All of a superstep's scalar stats in ONE blocking fetch: each
    node's packed row (`repro_torch.engine.records.pack_stats`) stacked
    on node 0's device, moved to the host once and reduced there."""
    home = out.new_labels[0].device
    rows = torch.stack([
        pack_stats(nl, ex, overflow=ovf, compact_overflow=cov,
                   device=nl.device).to(home)
        for nl, ex, ovf, cov in zip(out.new_labels, out.explored,
                                    out.overflow, out.compact_overflow)])
    rows = rows.cpu().numpy().astype(np.int64)
    return (int(rows[:, 0].sum()), int(rows[:, 1].sum()),
            bool(rows[:, 3].any()), bool(rows[:, 4].any()))


class DistributedPolicy(Policy):
    """The §5 superstep family as one engine policy."""

    eager_stats = True          # the Ψ switch and the compact fallback
                                # are host decisions per superstep

    def __init__(self, g, rank: np.ndarray, *, mesh, batch: int = 4,
                 beta: float = 8.0, first_superstep: int = 1,
                 cap: int, eta: int = 0, hc_cap: int = 64,
                 psi_threshold: Optional[float] = 100.0,
                 compact: int = 0, mode_name: str = "dgll",
                 verbose: bool = False,
                 monitor: Optional[HeartbeatMonitor] = None,
                 silent_after: Optional[Dict[int, int]] = None):
        self.name = mode_name
        self.g = g
        self.n = g.n
        self.cap = int(cap)
        self.mesh = mesh
        self.q = mesh.q
        if psi_threshold is None:
            psi_threshold = auto_psi_threshold(self.q)
        self.psi_threshold = float(psi_threshold)
        self.batch = int(batch)
        self.beta = float(beta)
        self.first_superstep = int(first_superstep)
        self.eta = int(eta)
        self.hc_cap = int(hc_cap)
        self.compact = int(compact)
        self.verbose = verbose
        self.rank = np.asarray(rank)
        self.queues = assign_roots(self.rank, self.q)
        # each device's operands and layout, built once per graph
        self.graph = mesh.replicate(
            lambda d: node_graph(g, self.rank, d, self.batch))
        self.plant_mode = self.psi_threshold > 0.0
        self.hc: Optional[List[LabelTable]] = None
        self._comm_label_slots = 0
        #: collective calls of each superstep this run committed: none
        #: in a PLaNT superstep, at least one in a DGLL superstep
        self.collective_calls: List[int] = []
        # fault tolerance (repro_torch.ft): ``monitor`` detects nodes
        # gone silent; ``silent_after`` is the simulation hook — node ->
        # the last superstep it completes before going dark (its masked
        # columns never run). Detected-dead nodes' unfinished roots are
        # re-PLaNTed on the survivors (§5.2: trees depend on nothing).
        self.monitor = monitor
        self.silent_after = dict(silent_after or {})
        self.dead_nodes: list = []
        self._silent_from_pos: Dict[int, int] = {}
        self._superstep = 0
        self._replanted_trees = 0
        self._replanted_labels = 0

    @functools.cached_property
    def fingerprint(self) -> str:
        return build_fingerprint(self.g, self.rank)

    def config(self) -> dict:
        return {"batch": self.batch, "beta": self.beta,
                "first_superstep": self.first_superstep,
                "eta": self.eta, "hc_cap": self.hc_cap,
                "psi_threshold": self.psi_threshold,
                "compact": self.compact, "q": self.q}

    # ------------------------------------------------------- schedule

    def schedule(self) -> QueueSchedule:
        return QueueSchedule(self.queues, self.batch, self.beta,
                             self.first_superstep)

    def _k0(self) -> int:
        """Prologue columns a node: ceil(η / q)."""
        return -(-self.eta // self.q)

    def begin(self, start_pos: int, resumed: bool) -> None:
        # the Common Label Table is stateless (PLaNT trees depend on
        # nothing), so it is rebuilt even on resume, never checkpointed
        if self.eta > 0:
            eta_eff = min(self._k0() * self.q, self.n)
            roots = rank_order(self.rank)[:eta_eff]
            self.hc = self.mesh.replicate(
                lambda d: build_common_table(
                    self.graph[self.mesh.devices.index(d)], roots,
                    self.hc_cap))
        else:
            self.hc = self.mesh.replicate(
                lambda d: lbl.empty(self.n, 1, d))

    def _run(self, sink, roots: np.ndarray, batch: int, plant: bool,
             use_hc: bool, compact: int = 0):
        fn = dgll_superstep_fn(self.mesh, self.n, batch=batch,
                               use_hc=use_hc, plant_trees=plant,
                               compact=compact)
        out = fn(sink.tables, self.hc, self.graph, roots, roots >= 0)
        sink.set_table(out.table)
        return out

    def prologue(self, sink) -> Optional[Tuple[StepOutcome, int]]:
        if self.eta <= 0:
            return None
        # the η trees' labels also enter their owners' partitions
        k0 = self._k0()
        roots = pad_step(self.queues, 0, k0, batch=k0)
        before = coll.total_calls()
        out = self._run(sink, roots, k0, plant=True, use_hc=False)
        nl, exp, ovf, _ = _fetch_mesh_stats(out)
        sink.note_overflow(ovf)
        self.collective_calls.append(coll.total_calls() - before)
        rec = make_record("plant-hc", labels=nl, explored=exp,
                          trees=int((roots >= 0).sum()))
        return StepOutcome(mode="plant-hc", record=rec,
                           trees=rec.trees), k0

    # -------------------------------------------------- heartbeats

    def _silent_nodes(self) -> set:
        """Nodes dark at the current superstep (simulation hook)."""
        return {node for node, last in self.silent_after.items()
                if self._superstep > int(last)}

    def _heartbeat(self, st: Step) -> Step:
        """Report live nodes to the monitor and mask silent nodes'
        work: a dead node's supersteps do not run."""
        if self.monitor is None and not self.silent_after:
            return st
        silent = self._silent_nodes()
        if self.monitor is not None:
            for node in range(self.q):
                if node not in silent:
                    self.monitor.report(node, self._superstep)
        if not silent:
            return st
        valid = np.asarray(st.valid).copy()
        for node in silent:
            # the queue position where this node's committed work ends:
            # everything from here on is its lost tail
            self._silent_from_pos.setdefault(node, st.pos)
            valid[node, :] = False
        return st._replace(valid=valid)

    def _recover(self, sink) -> None:
        """Declare the nodes the monitor lost and re-PLaNT their
        unfinished queues on the survivors."""
        if self.monitor is None:
            return
        for node in self.monitor.lost(self._superstep):
            if node in self.dead_nodes:
                continue
            self.dead_nodes.append(node)
            completed = self._silent_from_pos.get(node,
                                                  self.queues.shape[1])
            roots = lost_roots(self.queues, [node], completed)
            if self.verbose:
                print(f"  node {node} lost at superstep "
                      f"{self._superstep}; re-planting {len(roots)} "
                      "roots on survivors")
            if len(roots):
                self._replant(sink, roots)

    def _replant(self, sink, roots: np.ndarray) -> None:
        """One extra communication-free PLaNT superstep over the lost
        roots, spread round-robin across the surviving nodes (any node
        may plant any tree: canonical emissions are order-independent,
        so the labels land set-identical to an undisturbed run)."""
        survivors = [r for r in range(self.q)
                     if r not in set(self.dead_nodes)]
        if not survivors:
            raise RuntimeError("no surviving nodes to re-plant on")
        roots = np.asarray(roots, np.int32)
        S = len(survivors)
        T = -(-len(roots) // S)
        mat = np.full((self.q, T), -1, np.int32)
        for i, r in enumerate(roots):
            mat[survivors[i % S], i // S] = r
        out = self._run(sink, mat, T, plant=True, use_hc=self.eta > 0)
        nl, _, ovf, _ = _fetch_mesh_stats(out)
        sink.note_overflow(ovf)
        self._replanted_trees += int(len(roots))
        self._replanted_labels += nl

    # ----------------------------------------------------------------

    def step(self, st: Step, sink) -> StepOutcome:
        self._superstep += 1
        before = coll.total_calls()
        st = self._heartbeat(st)
        T = st.roots.shape[1]
        roots = np.where(np.asarray(st.valid), st.roots, -1)
        use_hc = self.eta > 0
        if self.plant_mode:
            out = self._run(sink, roots, self.batch, plant=True,
                            use_hc=use_hc)
            mode = "plant"
            nl, exp, ovf, _ = _fetch_mesh_stats(out)
        else:
            out = self._run(sink, roots, self.batch, plant=False,
                            use_hc=use_hc, compact=self.compact)
            mode = "dgll"
            slots = (self.q * T * min(self.compact, self.n)
                     if self.compact else self.q * T * self.n)
            nl, exp, ovf, compact_ovf = _fetch_mesh_stats(out)
            if self.compact and compact_ovf:
                # §Perf-2 fallback: the budget was too small for this
                # superstep's label yield, so it was completed densely
                mode = "dgll-dense-fallback"
                slots = self.q * T * self.n
            self._comm_label_slots += slots
        sink.note_overflow(ovf)
        self._recover(sink)
        self.collective_calls.append(coll.total_calls() - before)
        rec = make_record(mode, labels=nl, explored=exp,
                          trees=int(st.valid.sum()))
        return StepOutcome(mode=mode, record=rec, trees=rec.trees)

    def observe(self, record) -> None:
        if (self.plant_mode and record.mode != "plant-hc"
                and record.psi is not None
                and record.psi > self.psi_threshold):
            self.plant_mode = False    # Ψ too high: switch (§5.2.1)
            if self.verbose:
                print(f"  Ψ={record.psi:.1f} > "
                      f"Ψ_th={self.psi_threshold:.1f} -> switching to "
                      "DGLL")

    # ------------------------------------------------ checkpoint bits

    def meta(self) -> dict:
        return {"plant_mode": bool(self.plant_mode),
                "dead_nodes": [int(x) for x in self.dead_nodes]}

    def load_meta(self, meta: dict) -> None:
        self.plant_mode = bool(meta.get("plant_mode", self.plant_mode))
        self.dead_nodes = [int(x) for x in meta.get("dead_nodes", [])]

    def counters(self) -> Dict[str, int]:
        return {"comm_label_slots": self._comm_label_slots,
                "replanted_trees": self._replanted_trees,
                "replanted_labels": self._replanted_labels}

    def load_counters(self, counters: Dict[str, int]) -> None:
        self._comm_label_slots = int(counters.get("comm_label_slots", 0))
        self._replanted_trees = int(counters.get("replanted_trees", 0))
        self._replanted_labels = int(counters.get("replanted_labels", 0))

    def extras(self, sink) -> dict:
        return {"partitioned": sink.tables, "hc": self.hc[0],
                "q": self.q, "psi_threshold": self.psi_threshold,
                "comm_label_slots": self._comm_label_slots,
                "collective_calls": list(self.collective_calls)}
