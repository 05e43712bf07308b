"""The statistics plane: (P, Q, Omega) for every DC-ELM path.

Port of ``repro/core/stats.py`` (moment production and the factorized
solves; ``SufficientStats`` comes with the streaming slice). Algorithm 1
steps 1-3: h(x), P_i = H_i^T H_i, Q_i = H_i^T T_i and
Omega_i = (I/(VC) + P_i)^{-1}.

* Fused production: ``raw_moments`` sends affine/RBF feature maps with
  f32 accumulation to ``kernels/elm_stats_ops.fused_moments`` (kernel B1
  on the card), so the hidden matrix is never materialized. Other maps
  and the f64 path materialize H for the call.
* Factorized solves: Omega and every ridge solve go through a Cholesky
  factor (``torch.linalg.cholesky`` / ``cholesky_solve``); there is no
  matrix inverse.

Every function takes optional leading batch dims (a node axis).

Dtype policy: moments accumulate in f32 unless the inputs are f64;
operands below f32 (bf16) still accumulate in f32.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core.features import RandomFeatureMap, RBFFeatureMap


def accum_dtype(*operands) -> torch.dtype:
    """f32 accumulation, upgraded to f64 only by f64 inputs."""
    dt = functools.reduce(torch.promote_types, [o.dtype for o in operands])
    return torch.float64 if dt == torch.float64 else torch.float32


def fusable_params(feature_map):
    """(W, b, activation) for the fused kernels, or None.

    RandomFeatureMap -> (weights, bias, activation); RBFFeatureMap ->
    (centers^T, gamma, "rbf"). Anything else takes the materialized path.
    """
    if isinstance(feature_map, RandomFeatureMap):
        return feature_map.weights, feature_map.bias, feature_map.activation
    if isinstance(feature_map, RBFFeatureMap):
        return feature_map.centers.T, feature_map.gamma, "rbf"
    return None


def hidden_moments(H, T, *, dtype=None):
    """(P, Q) = (H^T H, H^T T) from a materialized H, f32/f64 acc.

    The cross moment promotes H to the wider of H/T, so f32 targets are
    never quantized down to a bf16 feature dtype.
    """
    dtype = accum_dtype(H, T) if dtype is None else dtype
    Hd = H.to(dtype)
    P = Hd.mT @ Hd
    op = torch.promote_types(H.dtype, T.dtype)
    Q = H.to(op).to(dtype).mT @ T.to(op).to(dtype)
    return P, Q


def raw_moments(X, T, feature_map, *, dtype=None):
    """(P, Q) from raw inputs; fused (H never materialized) when the
    feature map is affine/RBF and the accumulator is f32."""
    dtype = accum_dtype(X, T) if dtype is None else dtype
    params = fusable_params(feature_map)
    if params is not None and dtype == torch.float32:
        from repro_torch.kernels import elm_stats_ops

        W, b, activation = params
        return elm_stats_ops.fused_moments(X, W, b, T, activation=activation)
    return hidden_moments(feature_map(X), T, dtype=dtype)


def spd_solve(A, B):
    """Solve A X = B for symmetric positive-definite A via Cholesky."""
    return torch.cholesky_solve(B, torch.linalg.cholesky(A))


def _eye_like(P):
    L = P.shape[-1]
    return torch.eye(L, dtype=P.dtype, device=P.device).expand(P.shape)


def omega_from_moments(P, C: float, V: int = 1):
    """Omega = (I/(VC) + P)^{-1}, the preconditioner, via Cholesky."""
    eye = _eye_like(P)
    return spd_solve(eye / (V * C) + P, eye)


def finalize_moments(P, Q, C: float, V: int = 1):
    """(Omega, beta0) from bare moments (paper eq. 21)."""
    omega = omega_from_moments(P, C, V)
    return omega, omega @ Q


def ridge_solve_moments(P, Q, C: float):
    """beta = (I/C + P)^{-1} Q via Cholesky, when Omega is not needed."""
    return spd_solve(_eye_like(P) / C + P, Q)
