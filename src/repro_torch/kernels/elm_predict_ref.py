"""Plain PyTorch versions of the fused predict kernel (B4).

Port of ``repro/kernels/elm_predict_ref.py``. The dtype policy of the
fused kernel (``repro/kernels/elm_predict.py``, module docstring): the
hidden tile is computed in f32 (``elm_stats_ref.hidden_reference``),
rounded to the operand dtype (X's), promoted to beta's precision (beta
is never quantized down to the features), and Y accumulates in f32.
The result carries the promoted X/W/beta dtype (``predict_dtype``).

* ``predict_reference`` materializes H for all rows;
* ``elm_predict_scan`` streams N in ``chunk``-row slices. It is the CPU
  path of ``elm_predict_ops.fused_predict``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.elm_stats_ref import hidden_reference


def predict_dtype(X, W, beta) -> torch.dtype:
    """The result dtype: the promoted operand chain."""
    return torch.promote_types(
        torch.promote_types(X.dtype, W.dtype), beta.dtype
    )


def _readout(X, W, b, beta, activation):
    h = hidden_reference(X, W, b, activation).to(X.dtype)
    return h.float() @ beta.float()


def predict_reference(X, W, b, beta, *, activation: str = "sigmoid"):
    """Y = g(X W + b) @ beta via the materialized hidden matrix."""
    return _readout(X, W, b, beta, activation).to(predict_dtype(X, W, beta))


def elm_predict_scan(X, W, b, beta, *, activation: str = "sigmoid",
                     chunk: int = 4096):
    """Y streamed over N in ``chunk``-row slices (H never full)."""
    N = X.shape[0]
    Y = torch.empty((N, beta.shape[1]), dtype=predict_dtype(X, W, beta),
                    device=X.device)
    for start in range(0, N, chunk):
        Y[start:start + chunk] = _readout(
            X[start:start + chunk], W, b, beta, activation
        )
    return Y
