"""Centralized ELM (paper Sec. II-A), the fusion-center baseline.

Port of ``repro/core/elm.py``. Solves
min_beta 1/2 ||beta||^2 + C/2 ||H beta - T||^2 in closed form (eq. 3):

  beta* = (I_L/C + H^T H)^{-1} H^T T      when L <= N   ("primal")
  beta* = H^T (I_N/C + H H^T)^{-1} T      when N <= L   ("dual")
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import stats as stats_lib
from repro_torch.core.features import make_random_features


def ridge_primal(H, T, C: float):
    """beta = (I_L/C + H^T H)^{-1} H^T T via the statistics plane."""
    P, Q = stats_lib.hidden_moments(H, T)
    return stats_lib.ridge_solve_moments(P, Q, C)


def ridge_dual(H, T, C: float):
    """beta = H^T (I_N/C + H H^T)^{-1} T."""
    N = H.shape[0]
    G = H @ H.T
    A = torch.eye(N, dtype=H.dtype, device=H.device) / C + G
    return H.T @ stats_lib.spd_solve(A, T.to(A.dtype))


def ridge_solve(H, T, C: float,
                mode: Literal["auto", "primal", "dual"] = "auto"):
    """Paper eq. (3): pick the branch by which Gram matrix is smaller."""
    if mode == "auto":
        mode = "primal" if H.shape[-1] <= H.shape[0] else "dual"
    if mode == "primal":
        return ridge_primal(H, T, C)
    return ridge_dual(H, T, C)


def solve_from_stats(P, Q, C: float):
    """beta from sufficient statistics P = H^T H, Q = H^T T (primal)."""
    return stats_lib.ridge_solve_moments(P, Q, C)


@dataclasses.dataclass(frozen=True)
class ELM:
    """A trained ELM: frozen random feature map + learned output weights."""

    feature_map: object
    beta: torch.Tensor  # (L, M)

    def __call__(self, x):
        """f(x) = h(x) beta (paper eq. 2), through the fused predict."""
        from repro_torch.kernels import elm_predict_ops

        return elm_predict_ops.predict_map(x, self.feature_map, self.beta)


def train_centralized(
    generator: torch.Generator | None,
    X,
    T,
    *,
    num_features: int,
    C: float,
    activation: str = "sigmoid",
    mode: Literal["auto", "primal", "dual"] = "auto",
) -> ELM:
    """End-to-end centralized ELM training; the feature map is drawn from
    ``generator`` on X's device. The primal branch never materializes H
    on fusable maps; the dual branch (N < L) needs H H^T and builds H."""
    if T.dim() == 1:
        T = T[:, None]
    fmap = make_random_features(
        generator, X.shape[-1], num_features, activation,
        device=X.device,
    )
    if mode == "auto":
        mode = "primal" if num_features <= X.shape[0] else "dual"
    if mode == "primal":
        P, Q = stats_lib.raw_moments(X, T, fmap)
        beta = stats_lib.ridge_solve_moments(P, Q, C)
    else:
        beta = ridge_dual(fmap(X), T, C)
    return ELM(feature_map=fmap, beta=beta)


def mse(elm: ELM, X, T):
    if T.dim() == 1:
        T = T[:, None]
    return torch.mean(torch.square(elm(X) - T))
