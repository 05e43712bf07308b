"""Communication graphs (paper Sec. III-A).

Port of the graph half of ``repro/core/consensus.py``. Graphs are plain
numpy: they are built once on the host and lowered to tensors by the
mixers. The network is an undirected, connected V-node graph with
adjacency A (a_ii = 0, a_ij > 0 iff (i, j) in E) and degrees
d_i = sum_j a_ij. The DC-ELM step size must satisfy 0 < gamma < 1/d_max
(paper Thm. 2). Fault models and random geometric graphs come with a
later slice of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """An undirected weighted communication graph."""

    adjacency: np.ndarray  # (V, V), symmetric, zero diagonal
    name: str = "graph"

    def __post_init__(self):
        a = self.adjacency
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError("adjacency must be square")
        if not np.allclose(a, a.T):
            raise ValueError("graph must be undirected (A symmetric)")
        if np.any(np.diag(a) != 0):
            raise ValueError("a_ii must be 0")
        if np.any(a < 0):
            raise ValueError("edge weights must be nonnegative")

    @property
    def num_nodes(self) -> int:
        return self.adjacency.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1)

    @property
    def d_max(self) -> float:
        return float(self.degrees.max())

    def gamma_upper_bound(self) -> float:
        """Paper Thm. 2: 0 < gamma < 1/d_max."""
        return 1.0 / self.d_max

    def default_gamma(self, safety: float = 0.9) -> float:
        return safety * self.gamma_upper_bound()


def line(V: int) -> Graph:
    a = np.zeros((V, V))
    for i in range(V - 1):
        a[i, i + 1] = a[i + 1, i] = 1.0
    return Graph(a, name=f"line{V}")


def ring(V: int) -> Graph:
    if V < 3:
        return line(V)
    a = np.zeros((V, V))
    for i in range(V):
        j = (i + 1) % V
        a[i, j] = a[j, i] = 1.0
    return Graph(a, name=f"ring{V}")


def complete(V: int) -> Graph:
    a = np.ones((V, V)) - np.eye(V)
    return Graph(a, name=f"complete{V}")


def star(V: int) -> Graph:
    """Fusion-center-like topology (for contrast experiments)."""
    a = np.zeros((V, V))
    a[0, 1:] = a[1:, 0] = 1.0
    return Graph(a, name=f"star{V}")


def torus2d(rows: int, cols: int) -> Graph:
    """2-D torus."""
    V = rows * cols
    a = np.zeros((V, V))

    def idx(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            i = idx(r, c)
            for j in (idx(r + 1, c), idx(r, c + 1)):
                if i != j:
                    a[i, j] = a[j, i] = 1.0
    return Graph(a, name=f"torus{rows}x{cols}")


def hypercube(dim: int) -> Graph:
    """2^dim-node hypercube: log-diameter, great algebraic connectivity."""
    V = 1 << dim
    a = np.zeros((V, V))
    for i in range(V):
        for b in range(dim):
            j = i ^ (1 << b)
            a[i, j] = a[j, i] = 1.0
    return Graph(a, name=f"hypercube{dim}")


def paper_fig2() -> Graph:
    """The paper's Fig. 2 network: V=4, d_max=2 (a 4-cycle)."""
    return Graph(ring(4).adjacency, name="paper_fig2")


_BUILDERS = {
    "line": line,
    "ring": ring,
    "complete": complete,
    "star": star,
    "hypercube": hypercube,
}


def build(kind: str, V: int) -> Graph:
    """Build a named topology with V nodes."""
    if kind == "hypercube":
        dim = int(np.log2(V))
        if 1 << dim != V:
            raise ValueError(f"hypercube needs power-of-two V, got {V}")
        return hypercube(dim)
    if kind == "torus":
        r = int(np.sqrt(V))
        while V % r:
            r -= 1
        return torus2d(r, V // r)
    if kind in _BUILDERS:
        return _BUILDERS[kind](V)
    raise ValueError(f"unknown graph kind {kind!r}")
