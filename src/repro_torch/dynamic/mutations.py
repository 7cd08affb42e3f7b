"""Typed edge mutations for dynamic graphs.

A :class:`MutationBatch` is the unit of change the repair path
consumes: a set of edge-disjoint :class:`EdgeInsert` /
:class:`EdgeDelete` / :class:`EdgeReweight` records applied to an
undirected graph *atomically* (one batch = one repair wave = one
serving-epoch bump). Edge-disjointness keeps the semantics one-step —
"insert then reweight the same edge" is two batches, not one — and is
validated at construction.

``resolve(g)`` binds a batch to the pre-mutation graph: it validates
every record against the live edge set (deleting a missing edge or
inserting an existing one is an error, never a silent no-op) and
captures the old weights, which the affected-tree test in
:mod:`repro_torch.dynamic.frontier` needs. ``apply(g)`` produces the
post-mutation :class:`~repro_torch.graphs.graph.Graph` through the
canonical ``from_edges`` constructor, so a repaired index and a from-scratch
rebuild see byte-identical ELL/CSR arrays — a precondition for the
bit-identity guarantee.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Tuple, Union

import numpy as np

from repro_torch.graphs.graph import Graph, from_edges

#: resolved-kind codes (ResolvedBatch.kind)
INSERT, DELETE, REWEIGHT = 0, 1, 2

_KIND_NAMES = {INSERT: "insert", DELETE: "delete", REWEIGHT: "reweight"}


@dataclasses.dataclass(frozen=True)
class EdgeInsert:
    """Add undirected edge ``{u, v}`` with weight ``w``."""
    u: int
    v: int
    w: float
    kind: int = dataclasses.field(default=INSERT, init=False)


@dataclasses.dataclass(frozen=True)
class EdgeDelete:
    """Remove undirected edge ``{u, v}`` (must exist)."""
    u: int
    v: int
    kind: int = dataclasses.field(default=DELETE, init=False)


@dataclasses.dataclass(frozen=True)
class EdgeReweight:
    """Set the weight of existing edge ``{u, v}`` to ``w``."""
    u: int
    v: int
    w: float
    kind: int = dataclasses.field(default=REWEIGHT, init=False)


Mutation = Union[EdgeInsert, EdgeDelete, EdgeReweight]


@dataclasses.dataclass(frozen=True)
class ResolvedBatch:
    """A mutation batch bound to its pre-mutation graph: parallel
    arrays with the *old* weight captured for deletes/reweights (the
    affected-tree test evaluates those against the old graph) and the
    *new* weight for inserts/reweights (evaluated against the new)."""

    u: np.ndarray        # i64 [M]
    v: np.ndarray        # i64 [M]
    kind: np.ndarray     # i64 [M] — INSERT / DELETE / REWEIGHT
    w_old: np.ndarray    # f32 [M]; nan for inserts
    w_new: np.ndarray    # f32 [M]; nan for deletes

    def __len__(self) -> int:
        return len(self.u)


def _edge_dict(g: Graph) -> Dict[Tuple[int, int], float]:
    """Host map {(min(u,v), max(u,v)): w} of an undirected graph's
    edges (each symmetrized CSR arc pair contributes once)."""
    src = np.repeat(np.arange(g.n, dtype=np.int64),
                    np.diff(g.indptr).astype(np.int64))
    dst = g.indices.astype(np.int64)
    keep = src < dst
    return {(int(a), int(b)): float(w) for a, b, w in
            zip(src[keep], dst[keep], g.weights[keep])}


class MutationBatch:
    """An edge-disjoint batch of typed edge mutations.

    Structural validation (ids, weights, disjointness) happens here;
    graph-dependent validation (edge existence) happens in
    :meth:`resolve` / :meth:`apply`.
    """

    def __init__(self, mutations: Iterable[Mutation]):
        muts: List[Mutation] = list(mutations)
        seen = set()
        for m in muts:
            if not isinstance(m, (EdgeInsert, EdgeDelete, EdgeReweight)):
                raise TypeError(f"not an edge mutation: {m!r}")
            u, v = int(m.u), int(m.v)
            if u == v:
                raise ValueError(f"self-loop mutation ({u}, {v})")
            if u < 0 or v < 0:
                raise ValueError(f"negative vertex id in ({u}, {v})")
            key = (min(u, v), max(u, v))
            if key in seen:
                raise ValueError(
                    f"two mutations target edge {key}; a batch must be "
                    "edge-disjoint (split into sequential batches)")
            seen.add(key)
            w = getattr(m, "w", None)
            if w is not None and not (np.isfinite(w) and w > 0):
                raise ValueError(f"edge weight must be finite and "
                                 f"positive, got {w!r} for {key}")
        self.mutations: Tuple[Mutation, ...] = tuple(muts)

    def __len__(self) -> int:
        return len(self.mutations)

    def __iter__(self):
        return iter(self.mutations)

    @property
    def counts(self) -> Dict[str, int]:
        out = {"insert": 0, "delete": 0, "reweight": 0}
        for m in self.mutations:
            out[_KIND_NAMES[m.kind]] += 1
        return out

    def touched(self) -> np.ndarray:
        """Sorted unique endpoint ids — the seeds of the invalidation
        frontier."""
        ids = [x for m in self.mutations for x in (int(m.u), int(m.v))]
        return np.unique(np.asarray(ids, dtype=np.int64))

    def to_dict(self) -> dict:
        """JSON-safe form (the repair journal's durable intent
        record); round-trips exactly through :meth:`from_dict`."""
        rows = []
        for m in self.mutations:
            row = {"kind": _KIND_NAMES[m.kind],
                   "u": int(m.u), "v": int(m.v)}
            w = getattr(m, "w", None)
            if w is not None:
                row["w"] = float(w)
            rows.append(row)
        return {"mutations": rows}

    @classmethod
    def from_dict(cls, spec: dict) -> "MutationBatch":
        muts: List[Mutation] = []
        for row in spec["mutations"]:
            kind = row["kind"]
            if kind == "insert":
                muts.append(EdgeInsert(row["u"], row["v"], row["w"]))
            elif kind == "delete":
                muts.append(EdgeDelete(row["u"], row["v"]))
            elif kind == "reweight":
                muts.append(EdgeReweight(row["u"], row["v"], row["w"]))
            else:
                raise ValueError(f"unknown mutation kind {kind!r}")
        return cls(muts)

    def fingerprint(self) -> str:
        """Stable content hash; joins the repair policy's checkpoint
        fingerprint so a resume can never adopt label state committed
        for a different mutation batch."""
        h = hashlib.sha256()
        rows = sorted((m.kind, min(int(m.u), int(m.v)),
                       max(int(m.u), int(m.v)),
                       float(getattr(m, "w", -1.0)))
                      for m in self.mutations)
        for row in rows:
            h.update(repr(row).encode())
        return h.hexdigest()

    # -------------------------------------------------- graph binding

    def resolve(self, g: Graph) -> ResolvedBatch:
        """Bind to the pre-mutation graph, validating edge existence
        and capturing old weights."""
        if g.directed:
            raise NotImplementedError(
                "dynamic repair currently supports undirected graphs "
                "(directed repair is a ROADMAP item)")
        edges = _edge_dict(g)
        M = len(self.mutations)
        u = np.empty(M, np.int64)
        v = np.empty(M, np.int64)
        kind = np.empty(M, np.int64)
        w_old = np.full(M, np.nan, np.float32)
        w_new = np.full(M, np.nan, np.float32)
        for i, m in enumerate(self.mutations):
            a, b = int(m.u), int(m.v)
            if a >= g.n or b >= g.n:
                raise ValueError(f"mutation endpoint out of range for "
                                 f"n={g.n}: ({a}, {b})")
            key = (min(a, b), max(a, b))
            have = edges.get(key)
            if m.kind == INSERT:
                if have is not None:
                    raise ValueError(
                        f"insert of existing edge {key} (w={have}); "
                        "use EdgeReweight")
                w_new[i] = m.w
            else:
                if have is None:
                    name = _KIND_NAMES[m.kind]
                    raise ValueError(f"{name} of missing edge {key}")
                w_old[i] = have
                if m.kind == REWEIGHT:
                    w_new[i] = m.w
            u[i], v[i], kind[i] = a, b, m.kind
        return ResolvedBatch(u=u, v=v, kind=kind, w_old=w_old,
                             w_new=w_new)

    def apply(self, g: Graph) -> Graph:
        """The post-mutation graph, rebuilt through ``from_edges`` so
        its ELL/CSR layout is byte-identical to what a from-scratch
        construction on the same edge list would see."""
        rb = self.resolve(g)
        edges = _edge_dict(g)
        for i in range(len(rb)):
            key = (min(int(rb.u[i]), int(rb.v[i])),
                   max(int(rb.u[i]), int(rb.v[i])))
            k = int(rb.kind[i])
            if k == DELETE:
                del edges[key]
            else:                       # insert or reweight
                edges[key] = float(rb.w_new[i])
        if edges:
            src, dst = (np.asarray(x, np.int32)
                        for x in zip(*edges.keys()))
            w = np.asarray(list(edges.values()), np.float32)
        else:
            src = dst = np.zeros(0, np.int32)
            w = np.zeros(0, np.float32)
        return from_edges(g.n, src, dst, w, directed=False)


def random_mutations(g: Graph, rng: np.random.Generator, *,
                     inserts: int = 0, deletes: int = 0,
                     reweights: int = 0) -> MutationBatch:
    """A seeded, applicable mutation batch over ``g`` (launchers,
    benchmarks, tests): deletes/reweights pick disjoint existing
    edges, inserts pick non-edges, integral weights like the graph
    generators so path-sum equality stays f32-exact."""
    edges = _edge_dict(g)
    keys = sorted(edges.keys())
    need = deletes + reweights
    if need > len(keys):
        raise ValueError(f"graph has {len(keys)} edges; cannot pick "
                         f"{need} deletes+reweights")
    picked = rng.choice(len(keys), size=need, replace=False)
    w_hi = max(2, int(np.sqrt(g.n)))
    muts: List[Mutation] = []
    for j in picked[:deletes]:
        muts.append(EdgeDelete(*keys[int(j)]))
    for j in picked[deletes:]:
        u, v = keys[int(j)]
        muts.append(EdgeReweight(u, v, float(rng.integers(1, w_hi + 1))))
    used = set(keys[int(j)] for j in picked)
    while sum(isinstance(m, EdgeInsert) for m in muts) < inserts:
        a, b = (int(x) for x in rng.integers(0, g.n, 2))
        key = (min(a, b), max(a, b))
        if a == b or key in edges or key in used:
            continue
        used.add(key)
        muts.append(EdgeInsert(key[0], key[1],
                               float(rng.integers(1, w_hi + 1))))
    return MutationBatch(muts)
