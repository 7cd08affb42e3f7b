"""Graph I/O: the DIMACS shortest-path format (the paper's road
datasets come in it) and a compact npz format for generated graphs.
Host numpy; both packages read each other's files into equal arrays."""

from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import Graph, from_edges


def read_dimacs(path: str, directed: bool = False) -> Graph:
    """Read a DIMACS .gr file:  lines ``p sp <n> <m>`` / ``a u v w``.

    Vertex ids are 1-based in DIMACS; converted to 0-based.
    """
    n = None
    src, dst, w = [], [], []
    with open(path) as f:
        for line in f:
            if not line or line[0] in "c\n":
                continue
            parts = line.split()
            if parts[0] == "p":
                assert parts[1] == "sp", parts
                n = int(parts[2])
            elif parts[0] == "a":
                src.append(int(parts[1]) - 1)
                dst.append(int(parts[2]) - 1)
                w.append(float(parts[3]))
    assert n is not None, "missing 'p sp' header"
    return from_edges(n, np.asarray(src, np.int32),
                      np.asarray(dst, np.int32),
                      np.asarray(w, np.float32), directed=directed)


def write_dimacs(g: Graph, path: str) -> None:
    with open(path, "w") as f:
        f.write(f"p sp {g.n} {g.m}\n")
        for v in range(g.n):
            ids, ws = g.out_edges(v)
            for u, wt in zip(ids.tolist(), ws.tolist()):
                f.write(f"a {v + 1} {int(u) + 1} {wt:g}\n")


def save_npz(g: Graph, path: str) -> None:
    np.savez_compressed(
        path, n=g.n, m=g.m, directed=g.directed,
        indptr=g.indptr, indices=g.indices, weights=g.weights)


def load_npz(path: str) -> Graph:
    z = np.load(path)
    src = np.repeat(np.arange(int(z["n"]), dtype=np.int32),
                    np.diff(z["indptr"]).astype(np.int64))
    # an undirected CSR already stores both arc directions; from_edges'
    # dedupe makes re-symmetrization idempotent
    return from_edges(int(z["n"]), src, z["indices"], z["weights"],
                      directed=bool(z["directed"]))
