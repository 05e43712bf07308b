"""ConsensusEngine: the one DC-ELM update rule over a pluggable mixer.

Port of ``repro/core/engine.py`` (``DCELMRule``, ``ConsensusEngine``
``step`` / ``run`` / ``stream_init`` and ``simulated_dc_elm``). The
paper's fusion-center-free iteration (Algorithm 1, eq. 20)

    beta_i(k+1) = beta_i(k) + (gamma / VC) * Omega_i * lap_i,
    lap_i = sum_{j in N_i} a_ij (beta_j(k) - beta_i(k))

is factored as Engine = Mixer (who computes lap_i; ``core/mixers.py``)
x UpdateRule (what lap_i does to the state; ``DCELMRule`` here). The
streaming chunk updates of Algorithm 2, faults, compression and the
sharded engine come with later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import online
from repro_torch.core.consensus import Graph
from repro_torch.core.mixers import DenseMixer, NeighborMixer


@dataclasses.dataclass(frozen=True)
class DCELMRule:
    """Paper eq. (20): beta += (gamma/VC) * Omega @ lap.

    ``aux`` carries the stacked frozen preconditioners Omega_i with the
    same leading node axis as the state.
    """

    num_nodes: int
    C: float

    def __call__(self, x, lap, aux, gamma):
        V, C = self.num_nodes, self.C
        return x + (float(gamma) / (V * C)) * torch.bmm(aux, lap)


@dataclasses.dataclass(frozen=True)
class StreamState:
    """Stacked per-node streaming state.

    omegas: (V, L, L) current (I/(VC) + P_i)^{-1}
    Qs:     (V, L, M) current H_i^T T_i
    betas:  (V, L, M) node estimates
    """

    omegas: torch.Tensor
    Qs: torch.Tensor
    betas: torch.Tensor


@dataclasses.dataclass(frozen=True)
class ConsensusEngine:
    """One consensus iteration = rule(state, mixer.laplacian(state))."""

    mixer: Any
    rule: Callable

    def gamma_upper_bound(self) -> float | None:
        """Thm. 2's 1/d_max for the active mixer (None if it cannot say)."""
        fn = getattr(self.mixer, "gamma_upper_bound", None)
        return None if fn is None else float(fn())

    def _validate_gamma(self, gamma, check_gamma: bool) -> None:
        """Reject a gamma outside (0, 1/d_max) of the active mixer.

        ``check_gamma=False`` is the escape hatch for deliberate
        above-bound experiments (paper Fig. 4(a)).
        """
        if not check_gamma or gamma is None:
            return
        g = float(gamma)
        bound = self.gamma_upper_bound()
        if bound is None:
            return
        if not 0.0 < g < bound:
            raise ValueError(
                f"gamma={g:.6g} violates Thm. 2's 0 < gamma < 1/d_max "
                f"= {bound:.6g} for the active mixer. Pass "
                "check_gamma=False to run a deliberate divergence "
                "experiment."
            )

    def step(self, x, aux=None, gamma=None, k=0, *, check_gamma=True):
        """A single consensus round."""
        self._validate_gamma(gamma, check_gamma)
        return self.rule(x, self.mixer.laplacian(x, k), aux, gamma)

    def run(self, x, aux, gamma, num_iters: int, *, trace_fn=None,
            check_gamma=True):
        """num_iters rounds under the mixer's round loop.

        trace_fn: optional per-round metric over the stacked state.
        Returns (final_state, traces or None).
        """
        self._validate_gamma(gamma, check_gamma)
        return self.mixer.run(self.rule, x, aux, gamma, num_iters, trace_fn)

    def _ridge_constants(self):
        if not isinstance(self.rule, DCELMRule):
            raise TypeError("streaming DC-ELM requires a DCELMRule engine")
        return self.rule.C, self.rule.num_nodes

    def stream_init(self, H_nodes=None, T_nodes=None, *, X_nodes=None,
                    feature_map=None) -> StreamState:
        """Per-node sufficient statistics + local ridge seed.

        Two entry shapes, both through the statistics plane:

        * materialized features: ``stream_init(H_nodes, T_nodes)`` with
          H:(V,Ni,L), T:(V,Ni,M);
        * raw inputs: ``stream_init(X_nodes=X, T_nodes=T,
          feature_map=fmap)`` with X:(V,Ni,D); on fusable maps the
          hidden matrices are never materialized (kernel B1 on the card).
        """
        C, V = self._ridge_constants()
        if X_nodes is not None:
            if H_nodes is not None:
                raise ValueError("pass either H_nodes or X_nodes, not both")
            if feature_map is None:
                raise ValueError("X_nodes requires feature_map=")
            if T_nodes is None:
                raise ValueError("X_nodes requires T_nodes= targets")
            from repro_torch.core import stats as stats_lib

            if T_nodes.dim() == 2:
                T_nodes = T_nodes[..., None]
            P_, Q_ = stats_lib.raw_moments(X_nodes, T_nodes, feature_map)
            states = online.OnlineNodeState(
                omega=stats_lib.omega_from_moments(P_, C, V), Q=Q_
            )
        else:
            states = online.init_state(H_nodes, T_nodes, C, V)
        return StreamState(
            omegas=states.omega, Qs=states.Q,
            betas=online.reseed_betas(states),
        )


def simulated_dc_elm(
    graphs: Graph | list[Graph] | torch.Tensor,
    C: float,
    *,
    dtype=torch.float32,
    compress=None,
    mixer: str = "dense",
    device=None,
) -> ConsensusEngine:
    """DC-ELM over arbitrary dense graphs on one device.

    mixer: "dense" mixes via the dense adjacency product; "neighbor"
    selects ``mixers.NeighborMixer`` (kernel B2 on the card), which
    takes the dense program on graphs too dense for gathers to win.
    compress: None/"none" or "bf16" (the inline payload cast). Graphs
    go to ``device`` (default ``cuda``); an adjacency tensor keeps its
    own device.
    """
    try:
        cls = {"dense": DenseMixer, "neighbor": NeighborMixer}[mixer]
    except KeyError:
        raise ValueError(
            f'mixer must be "dense" or "neighbor", got {mixer!r}'
        ) from None
    if isinstance(graphs, (Graph, list)):
        mx = cls.from_graphs(
            graphs, dtype=dtype, compress=compress, device=device
        )
    else:
        mx = cls(graphs, compress=compress)
    return ConsensusEngine(mx, DCELMRule(mx.num_nodes, C))
