"""Plain PyTorch versions of the fused feature->moment kernel (B1).

Port of ``repro/kernels/elm_stats_ref.py``. Two functions, one
arithmetic, the dtype policy of the fused kernel
(``repro/kernels/elm_stats.py``, module docstring):

* the feature product runs with f32 accumulation on the operand dtype
  (X's dtype; W is cast to it), the activation runs in f32, and the
  hidden tile is rounded back to the operand dtype before the moment
  products;
* the cross moment promotes h to T's precision instead of quantizing
  T; both moments accumulate in f32.

bf16 operands are widened to f32 before each product. That is exact
(a bf16 x bf16 product fits an f32 mantissa), so the products equal
"bf16 operands, f32 accumulation" on any device. Inputs may carry a
leading node axis: X (V, N, D), T (V, N, M) -> P (V, L, L), Q (V, L, M).

* ``elm_stats_reference`` materializes the whole hidden matrix;
* ``elm_stats_scan`` streams N in ``chunk``-row slices, so peak memory
  is one chunk's hidden tile. It is the CPU path of
  ``elm_stats_ops.fused_moments``.
"""

from __future__ import annotations

import torch

from repro_torch.core.features import ACTIVATIONS, rbf_squared_dists


def _compute_dtype(*tensors) -> torch.dtype:
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.float64 if dt == torch.float64 else torch.float32


def hidden_reference(X, W, b, activation: str) -> torch.Tensor:
    """H = g(X W + b) in f32 (f64 for f64 operands).

    W is cast to X's dtype first (the kernel's operand dtype). For
    "rbf", W = centers^T and b = gamma.
    """
    W = W.to(X.dtype)
    dt = _compute_dtype(X, W, b)
    x, w, bb = X.to(dt), W.to(dt), b.to(dt)
    if activation == "rbf":
        return torch.exp(-bb * rbf_squared_dists(x, w.T))
    return ACTIVATIONS[activation](x @ w + bb)


def _moments(h, T):
    """(h^T h, h^T T) in f32 from an operand-rounded hidden tile."""
    hf = h.float()
    return hf.mT @ hf, hf.mT @ T.float()


def elm_stats_reference(X, W, b, T, *, activation: str = "sigmoid"):
    """(P, Q) via the materialized hidden matrix."""
    h = hidden_reference(X, W, b, activation).to(X.dtype)
    return _moments(h, T)


def elm_stats_scan(X, W, b, T, *, activation: str = "sigmoid",
                   chunk: int = 2048):
    """(P, Q) streamed over N in ``chunk``-row slices (H never full)."""
    N = X.shape[-2]
    L = W.shape[-1]
    M = T.shape[-1]
    lead = X.shape[:-2]
    P = torch.zeros(lead + (L, L), dtype=torch.float32, device=X.device)
    Q = torch.zeros(lead + (L, M), dtype=torch.float32, device=X.device)
    for start in range(0, N, chunk):
        x = X[..., start:start + chunk, :]
        t = T[..., start:start + chunk, :]
        dP, dQ = _moments(hidden_reference(x, W, b, activation).to(X.dtype), t)
        P += dP
        Q += dQ
    return P, Q
