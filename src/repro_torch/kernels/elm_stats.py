"""Kernel B1: fused feature -> moment pipeline on the card.

Wrapper of ``csrc/elm_stats.cu``, the port of the Pallas TPU kernel
``elm_stats_pallas`` (src/repro/kernels/elm_stats.py). Computes
(P, Q) = (H^T H, H^T T) with H = g(X W + b) for a stack of nodes without
writing H to device memory. Bound on the H100: operations (f32 FMA
units) at the flagship shapes; see the note in the CUDA source.

``elm_stats_cuda.launches`` counts the launches of the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build


def elm_stats_cuda(X, W, b, T, *, activation: str = "sigmoid"):
    """(P, Q) f32 on the card.

    X: (N, D) or (V, N, D), f32 or bf16 (the operand dtype; W is cast
    to it); W: (D, L); b: (L,); T: (N, M) or (V, N, M). For "rbf" pass
    W = centers^T and b = gamma. Returns P (.., L, L), Q (.., L, M).
    """
    if activation not in _build.ACT_IDS:
        raise ValueError(f"unknown activation {activation!r}")
    single = X.dim() == 2
    if single:
        X, T = X[None], T[None]
    if X.dim() != 3 or T.dim() != 3 or W.dim() != 2:
        raise ValueError(
            f"expected X (V,N,D), W (D,L), T (V,N,M); got {tuple(X.shape)}, "
            f"{tuple(W.shape)}, {tuple(T.shape)}"
        )
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"operand dtype must be f32 or bf16, got {X.dtype}")
    V, N, D = X.shape
    L = W.shape[1]
    M = T.shape[2]
    if W.shape[0] != D or b.shape != (L,) or T.shape[:2] != (V, N):
        raise ValueError("X, W, b and T shapes disagree")
    dev = _build.require_cuda("elm_stats_cuda", X, W, b, T)
    X = X.contiguous()
    W = W.to(X.dtype).contiguous()
    b = b.to(torch.float32).contiguous()
    T = T.to(torch.float32).contiguous()  # bf16 -> f32 is exact
    P = torch.empty((V, L, L), dtype=torch.float32, device=dev)
    Q = torch.empty((V, L, M), dtype=torch.float32, device=dev)
    if V and L:
        lib = _build.library("elm_stats")
        with torch.cuda.device(dev):
            err = lib.elm_stats_launch(
                X.data_ptr(), W.data_ptr(), b.data_ptr(), T.data_ptr(),
                P.data_ptr(), Q.data_ptr(), V, N, D, L, M,
                _build.ACT_IDS[activation], int(X.dtype == torch.bfloat16),
                _build.stream_handle(dev),
            )
        _build.check(err, "elm_stats_cuda")
        elm_stats_cuda.launches += 1
    return (P[0], Q[0]) if single else (P, Q)


elm_stats_cuda.launches = 0
