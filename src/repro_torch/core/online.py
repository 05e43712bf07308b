"""Online DC-ELM node state (the part of ``repro/core/online.py`` that
``ConsensusEngine.stream_init`` needs; the Woodbury chunk updates of
Algorithm 2 come with the streaming slice)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import stats as stats_lib


@dataclasses.dataclass(frozen=True)
class OnlineNodeState:
    """Node-local online-ELM statistics (leading node axis allowed).

    omega: (..., L, L) current (I/(VC) + P)^{-1}
    Q:     (..., L, M) current H^T T
    """

    omega: torch.Tensor
    Q: torch.Tensor


def init_state(H, T, C: float, V: int) -> OnlineNodeState:
    """Warm-up statistics via the statistics plane (Cholesky Omega)."""
    P_, Q_ = stats_lib.hidden_moments(H, T)
    return OnlineNodeState(
        omega=stats_lib.omega_from_moments(P_, C, V), Q=Q_
    )


def reseed_betas(states: OnlineNodeState) -> torch.Tensor:
    """Stacked beta_i = Omega_i Q_i after an update (Algorithm 2 step 13)."""
    return torch.bmm(states.omega, states.Q)
