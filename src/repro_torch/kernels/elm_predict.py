"""Kernel B4: fused predict Y = g(X W + b) @ beta on the card.

Wrapper of ``csrc/elm_predict.cu``, the port of the Pallas TPU kernel
``elm_predict_pallas`` (src/repro/kernels/elm_predict.py). The hidden
matrix never reaches device memory. Bound on the H100: operations (the
f32 readout); see the note in the CUDA source, which also records the
feature recomputation per output tile left for a later change.

``elm_predict_cuda.launches`` counts the launches of the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def elm_predict_cuda(X, W, b, beta, *, activation: str = "sigmoid"):
    """Y (N, M) f32 on the card.

    X: (N, D) f32 or bf16 (the operand dtype; W is cast to it);
    W: (D, L); b: (L,); beta: (L, M), f32 or bf16, never quantized to
    the features. For "rbf" pass W = centers^T and b = gamma.
    """
    if activation not in _build.ACT_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    if X.dim() != 2 or W.dim() != 2 or beta.dim() != 2:
        raise ValueError(
            f"expected X (N,D), W (D,L), beta (L,M); got {tuple(X.shape)}, "
            f"{tuple(W.shape)}, {tuple(beta.shape)}"
        )
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand dtype must be f32 or bf16, got {X.dtype}")
    N, D = X.shape
    L = W.shape[1]
    M = beta.shape[1]
    if W.shape[0] != D or b.shape != (L,) or beta.shape[0] != L:
        raise ValueError("X, W, b and beta shapes disagree")
    if beta.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"beta must be f32 or bf16, got {beta.dtype}")
    dev = _build.require_cuda("elm_predict_cuda", X, W, b, beta)
    X = X.contiguous()
    W = W.to(X.dtype).contiguous()
    b = b.to(torch.float32).contiguous()
    beta = beta.to(torch.float32).contiguous()  # bf16 -> f32 is exact
    Y = torch.empty((N, M), dtype=torch.float32, device=dev)
    if N and M:
        lib = _build.library("elm_predict")
        with torch.cuda.device(dev):
            err = lib.elm_predict_launch(
                X.data_ptr(), W.data_ptr(), b.data_ptr(), beta.data_ptr(),
                Y.data_ptr(), N, D, L, M, _build.ACT_IDS[activation],
                int(X.dtype == torch.bfloat16), _build.stream_handle(dev),
            )
        _build.check(err, "elm_predict_cuda")
        elm_predict_cuda.launches += 1
    return Y


elm_predict_cuda.launches = 0
