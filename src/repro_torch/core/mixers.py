"""Communication backends ("mixers") for the ConsensusEngine.

Port of ``DenseMixer`` and ``NeighborMixer`` of ``repro/core/mixers.py``.
A mixer computes the network Laplacian term

    lap_i = sum_{j in N_i} a_ij (x_j - x_i)

for a state with a leading node axis, and drives many consensus rounds.
The update rule itself lives in ``core/engine.py``.

* ``DenseMixer`` mixes through the dense adjacency (optionally a
  sequence of adjacencies for a time-varying topology).
* ``NeighborMixer`` is the same mixer, lowered at construction to padded
  neighbor lists; its DC-ELM round loop runs through
  ``kernels/elm_gossip_ops.fused_gossip_rounds`` (kernel B2 on the card).

Both take the inline payload compression knob (``None`` / ``"none"`` /
``"bf16"``). The compressed, secure, faulty and sharded mixers come with
later slices of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.consensus import Graph
from repro_torch.utils.device import resolve_device

#: modes the inline ``compress=`` knob understands
INLINE_COMPRESS_MODES = (None, "none", "bf16")


def _normalize_compress(mode: str | None) -> str | None:
    if mode in (None, "none"):
        return None
    if mode == "bf16":
        return mode
    raise ValueError(
        f"unknown gossip compression {mode!r}: the inline mixer knob "
        f"accepts {INLINE_COMPRESS_MODES}"
    )


def compress_payload(x: torch.Tensor, mode: str | None) -> torch.Tensor:
    """Quantize a gossip payload (paper Sec. V)."""
    if _normalize_compress(mode) is None:
        return x
    return x.to(torch.bfloat16)


def _mix_dtype(payload_dtype) -> torch.dtype:
    """Accumulate the Laplacian at least in f32 (bf16 payloads upcast)."""
    return torch.promote_types(payload_dtype, torch.float32)


def _stack_adjacencies(graphs: Graph | Sequence[Graph]) -> np.ndarray:
    """(S, V, V) host adjacency of one graph or a snapshot sequence."""
    if isinstance(graphs, Graph):
        graphs = [graphs]
    return np.stack([np.asarray(g.adjacency) for g in graphs])


class DenseMixer:
    """Dense-adjacency mixing over a stacked leading node axis.

    adjacencies: (V, V) for a static graph, or (S, V, V) for a
    time-varying sequence; round k mixes with snapshot k % S.
    """

    def __init__(self, adjacencies: torch.Tensor, *, compress=None):
        if adjacencies.dim() == 2:
            adjacencies = adjacencies[None]
        if adjacencies.dim() != 3 or (
            adjacencies.shape[-1] != adjacencies.shape[-2]
        ):
            raise ValueError(
                "adjacencies must be (V,V) or (S,V,V), got "
                f"{tuple(adjacencies.shape)}"
            )
        self.adjacencies = adjacencies
        self.degrees = torch.sum(adjacencies, dim=-1)
        self.compress = _normalize_compress(compress)

    @classmethod
    def from_graphs(
        cls, graphs: Graph | Sequence[Graph], *, dtype=torch.float32,
        compress=None, device=None,
    ):
        adjs = _stack_adjacencies(graphs)
        return cls(
            torch.as_tensor(adjs, dtype=dtype, device=resolve_device(device)),
            compress=compress,
        )

    @property
    def num_nodes(self) -> int:
        return self.adjacencies.shape[-1]

    def gamma_upper_bound(self) -> float:
        """Paper Thm. 2: 1 / max_k d_max(G_k), joint over snapshots."""
        return 1.0 / float(torch.max(self.degrees))

    def _snapshot(self, k):
        S = self.adjacencies.shape[0]
        return self.adjacencies[k % S], self.degrees[k % S]

    def laplacian(self, x, k=0):
        """Stacked Laplacian term A @ x - deg * x over the node axis."""
        adj, deg = self._snapshot(k)
        flat = x.reshape(x.shape[0], -1)
        payload = compress_payload(flat, self.compress)
        dt = _mix_dtype(payload.dtype)
        p = payload.to(dt)
        lap = adj.to(dt) @ p - deg.to(dt)[:, None] * p
        return lap.to(x.dtype).reshape(x.shape)

    def run(self, rule, x, aux, gamma, num_iters: int, trace_fn=None):
        """num_iters rounds of ``rule(x, laplacian(x, k), aux, gamma)``.

        Returns (final state, stacked per-round traces or None).
        """
        traces = []
        for k in range(num_iters):
            x = rule(x, self.laplacian(x, k), aux, gamma)
            if trace_fn is not None:
                traces.append(trace_fn(x))
        if trace_fn is None:
            return x, None
        return x, torch.stack(traces) if traces else None


class NeighborMixer(DenseMixer):
    """Neighbor-sparse mixing through the fused gossip kernel plane.

    Semantically a ``DenseMixer``, but the adjacency is also lowered at
    construction to padded neighbor lists
    (``kernels/elm_gossip_ref.neighbor_lists``) and:

    * ``run`` with a ``DCELMRule`` over stacked f32 betas executes the
      whole round loop through ``elm_gossip_ops.fused_gossip_rounds``
      (kernel B2 on the card), so the dense product and the Laplacian
      never reach device memory;
    * ``laplacian`` gathers over neighbor slots whenever the graph is
      genuinely sparse (2 d_max < V).

    On graphs too dense for gathers to win (``prefers_dense``) every
    path takes the exact DenseMixer program.
    """

    def __init__(self, adjacencies: torch.Tensor, *, compress=None,
                 host_adjacencies: np.ndarray | None = None):
        """host_adjacencies: the same snapshots as a numpy array, when the
        caller has them; the lists are then built from it and uploaded,
        and the device adjacency is never read back."""
        super().__init__(adjacencies, compress=compress)
        from repro_torch.kernels import elm_gossip_ref

        adj = self.adjacencies if host_adjacencies is None else host_adjacencies
        idx, w, _ = elm_gossip_ref.neighbor_lists(
            adj, device=self.adjacencies.device)
        self.neighbor_idx = idx
        self.neighbor_w = w.to(self.adjacencies.dtype)
        self.d_max = int(idx.shape[-1])

    @classmethod
    def from_graphs(
        cls, graphs: Graph | Sequence[Graph], *, dtype=torch.float32,
        compress=None, device=None,
    ):
        adjs = _stack_adjacencies(graphs)
        return cls(
            torch.as_tensor(adjs, dtype=dtype, device=resolve_device(device)),
            compress=compress, host_adjacencies=adjs,
        )

    def _lists_row(self, k):
        S = self.adjacencies.shape[0]
        return (
            self.neighbor_idx[k % S],
            self.neighbor_w[k % S],
            self.degrees[k % S],
        )

    def laplacian(self, x, k=0):
        from repro_torch.kernels import elm_gossip_ops, elm_gossip_ref

        if elm_gossip_ops.laplacian_prefers_dense(self.num_nodes, self.d_max):
            return super().laplacian(x, k)
        idx_k, w_k, deg_k = self._lists_row(k)
        flat = x.reshape(x.shape[0], -1)
        payload = compress_payload(flat, self.compress)
        lap = elm_gossip_ref.neighbor_laplacian(payload, idx_k, w_k, deg_k)
        return lap.to(x.dtype).reshape(x.shape)

    def _fused_ok(self, rule, x, aux, gamma) -> bool:
        """The fused kernel covers exactly the DC-ELM hot path: stacked
        f32 (V, L, M) betas, (V, L, L) f32 Omegas, a gamma, inline
        payload mode None/bf16, on a graph sparse enough for the gather
        formulation to win."""
        from repro_torch.core.engine import DCELMRule
        from repro_torch.kernels import elm_gossip_ops

        if not isinstance(rule, DCELMRule) or gamma is None:
            return False
        if not (
            isinstance(x, torch.Tensor)
            and x.dim() == 3
            and x.dtype == torch.float32
        ):
            return False
        V, L, M = x.shape
        if V != self.num_nodes:
            return False
        if not (
            isinstance(aux, torch.Tensor)
            and tuple(aux.shape) == (V, L, L)
            and aux.dtype == torch.float32
        ):
            return False
        return not elm_gossip_ops.prefers_dense(
            V, self.d_max, L, M, device=x.device
        )

    def _scale(self, rule, gamma):
        return float(gamma) / (rule.num_nodes * rule.C)

    def run(self, rule, x, aux, gamma, num_iters: int, trace_fn=None):
        if (
            trace_fn is not None
            or num_iters <= 0
            or not self._fused_ok(rule, x, aux, gamma)
        ):
            return super().run(rule, x, aux, gamma, num_iters, trace_fn)
        from repro_torch.kernels import elm_gossip_ops

        final = elm_gossip_ops.fused_gossip_rounds(
            x, aux, self.neighbor_idx, self.neighbor_w, self.degrees,
            self._scale(rule, gamma), num_rounds=num_iters,
            compress=self.compress,
        )
        return final, None
