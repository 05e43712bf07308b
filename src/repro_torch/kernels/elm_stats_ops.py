"""Dispatch of the fused feature->moment computation by device.

Port of ``repro/kernels/elm_stats_ops.py``. CUDA tensors launch kernel
B1 (``elm_stats.elm_stats_cuda``); CPU tensors take the plain streaming
version (``elm_stats_ref.elm_stats_scan``). There is no knob that sends
a CUDA tensor to the plain version. Block sizes are fixed in the CUDA
source; the tuner comes with a later slice.
"""

from __future__ import annotations


def fused_moments(X, W, b, T, *, activation: str = "sigmoid"):
    """(P, Q) f32 from raw inputs without materializing H.

    X: (N, D) or (V, N, D); T: (N, M) or (V, N, M). For "rbf" pass
    W = centers^T and b = gamma.
    """
    if X.is_cuda:
        from repro_torch.kernels.elm_stats import elm_stats_cuda

        return elm_stats_cuda(X, W, b, T, activation=activation)
    from repro_torch.kernels.elm_stats_ref import elm_stats_scan

    return elm_stats_scan(X, W, b, T, activation=activation)
