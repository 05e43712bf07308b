"""Dispatch of the fused predict by device, and the FeatureMap entry.

Port of ``repro/kernels/elm_predict_ops.py``. CUDA tensors launch kernel
B4 (``elm_predict.elm_predict_cuda``); CPU tensors take the plain
streaming version (``elm_predict_ref.elm_predict_scan``).

``predict_map`` keeps the reference's routing rules, which are
semantics and not fallbacks: ``feature_map=None`` means x already is the
feature matrix; non-fusable maps and f64 inputs materialize H for the
call; an empty batch (N = 0) has no rows to tile and does the same.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.elm_predict_ref import predict_dtype


def fused_predict(X, W, b, beta, *, activation: str = "sigmoid"):
    """Y = g(X W + b) @ beta without materializing H.

    Returns the promoted X/W/beta dtype with f32 accumulation inside.
    For "rbf" pass W = centers^T and b = gamma.
    """
    out_dtype = predict_dtype(X, W, beta)
    if X.is_cuda:
        from repro_torch.kernels.elm_predict import elm_predict_cuda

        return elm_predict_cuda(
            X, W, b, beta, activation=activation
        ).to(out_dtype)
    from repro_torch.kernels.elm_predict_ref import elm_predict_scan

    return elm_predict_scan(X, W, b, beta, activation=activation)


def predict_map(x, feature_map, beta):
    """f(x) = h(x) @ beta for any feature map, fused where fusable.

    x: (..., D) with arbitrary leading dims (flattened to rows for the
    kernel and restored).
    """
    from repro_torch.core.features import promote_matmul
    from repro_torch.core.stats import fusable_params

    if feature_map is None:
        return promote_matmul(x, beta)
    params = fusable_params(feature_map)
    if params is None or torch.promote_types(x.dtype, beta.dtype) == torch.float64:
        return promote_matmul(feature_map(x), beta)
    W, b, activation = params
    lead = x.shape[:-1]
    rows = x.reshape(-1, x.shape[-1])
    if rows.shape[0] == 0:
        return promote_matmul(feature_map(x), beta)
    Y = fused_predict(rows, W, b, beta, activation=activation)
    return Y.reshape(*lead, beta.shape[-1])
