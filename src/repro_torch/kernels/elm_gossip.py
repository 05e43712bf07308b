"""Kernel B2: one fused eq. (20) consensus round per launch, on the card.

Wrapper of ``csrc/elm_gossip.cu``, the port of the state arm of the
Pallas TPU kernel ``elm_gossip_pallas`` (src/repro/kernels/
elm_gossip.py), both payload modes (``compress=None`` and ``"bf16"``).
Bound on the H100: memory (each round reads every Omega_i).

A round reads the old state of every neighbor, so rounds ping-pong
between two buffers and never update in place.

``elm_gossip_round_cuda.launches`` counts the launches of the kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.elm_gossip_ref import _check_compress


def elm_gossip_round_cuda(betas, omegas, idx_k, w_k, deg_k, scale, out, *,
                          bf16: bool = False):
    """out <- one round of ``betas`` (f32, contiguous; out must not alias).

    betas/out: (V, L, M); omegas: (V, L, L); idx_k (int32) / w_k:
    (V, d_max), one snapshot; deg_k: (V,).
    """
    V, L, M = betas.shape
    d_max = idx_k.shape[1]
    dev = _build.require_cuda(
        "elm_gossip_round_cuda", betas, omegas, idx_k, w_k, deg_k, out
    )
    if out.data_ptr() == betas.data_ptr():
        raise ValueError("a gossip round must not update the state in place")
    lib = _build.library("elm_gossip")
    with torch.cuda.device(dev):
        err = lib.elm_gossip_round_launch(
            betas.data_ptr(), omegas.data_ptr(), idx_k.data_ptr(),
            w_k.data_ptr(), deg_k.data_ptr(), out.data_ptr(),
            V, L, M, d_max, float(scale), int(bf16),
            _build.stream_handle(dev),
        )
    _build.check(err, "elm_gossip_round_cuda")
    elm_gossip_round_cuda.launches += 1
    return out


elm_gossip_round_cuda.launches = 0


def elm_gossip_cuda(betas, omegas, idx, w, deg, scale, *, num_rounds,
                    compress=None):
    """num_rounds rounds, one launch each; round k uses snapshot k % S.

    betas: (V, L, M) f32; omegas: (V, L, L); idx/w: (S, V, d_max);
    deg: (S, V); scale = gamma / (V C).
    """
    bf16 = _check_compress(compress) == "bf16"
    if betas.dim() != 3 or betas.dtype != torch.float32:
        raise ValueError(
            f"the gossip kernel takes f32 (V, L, M) betas, got "
            f"{betas.dtype} {tuple(betas.shape)}"
        )
    V, L, M = betas.shape
    S = idx.shape[0]
    if (omegas.shape != (V, L, L) or idx.shape[1] != V or w.shape != idx.shape
            or deg.shape != (S, V)):
        raise ValueError("betas, omegas and neighbor-list shapes disagree")
    omegas = omegas.to(torch.float32).contiguous()
    idx = idx.to(torch.int32).contiguous()
    if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= V):
        raise ValueError(f"neighbor indices must lie in [0, {V})")
    w = w.to(torch.float32).contiguous()
    deg = deg.to(torch.float32).contiguous()
    src = betas.contiguous().clone()
    if num_rounds <= 0:
        return src
    dst = torch.empty_like(src)
    for k in range(num_rounds):
        s = k % S
        elm_gossip_round_cuda(
            src, omegas, idx[s], w[s], deg[s], scale, dst, bf16=bf16
        )
        src, dst = dst, src
    return src
