"""DC-ELM, the paper's Algorithm 1 in batch form (simulated path).

Port of ``repro/core/dc_elm.py`` (the single-device ``simulate_*`` path,
node prediction and the references the tests use). Per-node state and
iteration (paper eqs. 20-21):

    P_i = H_i^T H_i,  Q_i = H_i^T T_i
    Omega_i = (I_L / (V C) + P_i)^{-1}
    beta_i(0) = Omega_i Q_i
    beta_i(k+1) = beta_i(k)
        + (gamma / (V C)) * Omega_i * sum_{j in N_i} a_ij (beta_j - beta_i)

with 0 < gamma < 1/d_max. The iteration lives in ``core/engine.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import engine as engine_lib
from repro_torch.core import stats as stats_lib
from repro_torch.core.consensus import Graph


@dataclasses.dataclass(frozen=True)
class DCELMState:
    """Stacked per-node DC-ELM state.

    betas:  (V, L, M)  node estimates beta_i(k)
    omegas: (V, L, L)  frozen preconditioners Omega_i
    k:      iteration counter
    """

    betas: torch.Tensor
    omegas: torch.Tensor
    k: int = 0

    @property
    def num_nodes(self) -> int:
        return self.betas.shape[0]


def init_node(P_, Q_, C: float, V: int):
    """Omega_i and beta_i(0) from local stats (paper eq. 21)."""
    return stats_lib.finalize_moments(P_, Q_, C, V)


def gradient_sum(state: DCELMState, P_, Q_, C: float):
    """sum_i grad u_i(beta_i), zero along the invariant manifold (eq. 12).

    grad u_i(beta) = beta + VC (P_i beta - Q_i).
    """
    V = state.num_nodes
    g = state.betas + V * C * (torch.bmm(P_, state.betas) - Q_)
    return torch.sum(g, dim=0)


def simulate_init_raw(X_nodes, T_nodes, feature_map, C: float):
    """Initialize straight from raw inputs X:(V,Ni,D), T:(V,Ni,M).

    On fusable feature maps the hidden matrices are never materialized
    (kernel B1 on the card). Returns (state, P:(V,L,L), Q:(V,L,M)).
    """
    if T_nodes.dim() == 2:
        T_nodes = T_nodes[..., None]
    V = X_nodes.shape[0]
    P_, Q_ = stats_lib.raw_moments(X_nodes, T_nodes, feature_map)
    omegas, betas = init_node(P_, Q_, C, V)
    return DCELMState(betas=betas, omegas=omegas), P_, Q_


def simulate_run(
    state: DCELMState,
    graph: Graph,
    gamma: float,
    C: float,
    num_iters: int,
    *,
    trace_fn: Callable[[torch.Tensor], torch.Tensor] | None = None,
    check_gamma: bool = True,
):
    """Run num_iters rounds through the engine on the state's device.

    check_gamma=False skips the Thm. 2 bound validation. Returns
    (final_state, traces or None).
    """
    eng = engine_lib.simulated_dc_elm(
        graph, C, dtype=state.betas.dtype, device=state.betas.device
    )
    betas, traces = eng.run(
        state.betas, state.omegas, gamma, num_iters, trace_fn=trace_fn,
        check_gamma=check_gamma,
    )
    final = dataclasses.replace(state, betas=betas, k=state.k + num_iters)
    return final, traces


def simulate_train(
    generator: torch.Generator | None,
    X_nodes,
    T_nodes,
    *,
    num_features: int,
    C: float,
    graph: Graph,
    gamma: float | None = None,
    num_iters: int = 100,
    activation: str = "sigmoid",
    trace_fn: Callable | None = None,
):
    """End-to-end DC-ELM (Algorithm 1) on stacked node data X:(V,Ni,D)."""
    from repro_torch.core.features import make_random_features

    fmap = make_random_features(
        generator, X_nodes.shape[-1], num_features, activation,
        device=X_nodes.device,
    )
    state, _, _ = simulate_init_raw(X_nodes, T_nodes, fmap, C)
    if gamma is None:
        gamma = graph.default_gamma()
    final, traces = simulate_run(
        state, graph, gamma, C, num_iters, trace_fn=trace_fn
    )
    return fmap, final, traces


def node_predict(fmap, betas, X):
    """(V, N, M): every node's own answer on shared query rows X.

    The stacked betas fold into one (L, V*M) readout, so the N*D*L
    feature work is shared across the V node models: one fused predict
    (kernel B4 on the card) answers for every node.
    """
    from repro_torch.kernels import elm_predict_ops

    V, L, M = betas.shape
    wide = betas.permute(1, 0, 2).reshape(L, V * M)
    Y = elm_predict_ops.predict_map(X, fmap, wide)
    return torch.movedim(Y.reshape(*Y.shape[:-1], V, M), -2, 0)


def centralized_from_node_stats(P_, Q_, C: float):
    """beta* = (I/C + sum_i P_i)^{-1} (sum_i Q_i), the fusion-center
    answer the distributed iterations must reach."""
    return stats_lib.ridge_solve_moments(
        torch.sum(P_, dim=0), torch.sum(Q_, dim=0), C
    )


def consensus_error(betas):
    """Max over nodes of ||beta_i - mean beta|| / (1 + ||mean beta||)."""
    mean = torch.mean(betas, dim=0, keepdim=True)
    num = torch.max(torch.sqrt(torch.sum((betas - mean) ** 2, dim=(1, 2))))
    den = 1.0 + torch.sqrt(torch.sum(mean**2))
    return num / den


def distance_to(betas, target):
    """Max over nodes of relative Frobenius distance to target."""
    num = torch.sqrt(torch.sum((betas - target[None]) ** 2, dim=(1, 2)))
    den = 1.0 + torch.sqrt(torch.sum(target**2))
    return torch.max(num) / den
