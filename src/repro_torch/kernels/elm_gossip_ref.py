"""Plain PyTorch versions of the fused gossip round (B2).

Port of ``repro/kernels/elm_gossip_ref.py``. The consensus plane's hot
loop is the paper's eq. (20) update

    beta_i += (gamma / VC) * Omega_i @ lap_i,
    lap_i   = sum_{j in N_i} a_ij (beta_j - beta_i),

over padded neighbor lists: per node, ``d_max`` slots of (index,
weight), zero-weight slots padding short rows.

* ``neighbor_lists`` builds the lists from dense adjacency snapshots;
* ``neighbor_laplacian`` / ``gossip_round_reference`` are one round;
* ``elm_gossip_scan`` runs many rounds (round k uses snapshot k % S).
  It is the CPU path of ``elm_gossip_ops.fused_gossip_rounds``;
* ``dense_gossip_rounds`` is the same rounds through the dense
  (V, V) @ (V, L*M) product, the exact DenseMixer + DCELMRule program.

``compress="bf16"`` rounds every element of the gossiped payload (the
gathered neighbors and the self term) to bf16 before the Laplacian is
formed; accumulation stays in f32 and the state dtype is unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.bridge import to_torch

#: payload modes the kernel plane understands
PAYLOAD_MODES = (None, "none", "bf16")


def _check_compress(compress):
    if compress not in PAYLOAD_MODES:
        raise ValueError(
            f"unknown gossip payload mode {compress!r}: the kernel plane "
            f"accepts {PAYLOAD_MODES}"
        )
    return None if compress == "none" else compress


def _payload(betas, compress):
    if _check_compress(compress) == "bf16":
        return betas.to(torch.bfloat16)
    return betas


def _acc_dtype(payload_dtype):
    """Accumulate the Laplacian at least in f32."""
    return torch.promote_types(payload_dtype, torch.float32)


def neighbor_lists(adjacencies, *, device=None):
    """Padded CSR-style neighbor lists from dense adjacency snapshots.

    adjacencies: (V, V) or (S, V, V), numpy or a tensor (a tensor's
    device wins over ``device``). Returns ``(idx, w, deg)``:

    * idx: (S, V, d_max) int32 neighbor indices, short rows padded with
      index 0 (valid, and used only through its zero weight);
    * w:   (S, V, d_max) edge weights a_ij, padding slots 0;
    * deg: (S, V) weighted degrees sum_j a_ij.

    d_max is the largest live-neighbor count over all snapshots (>= 1).
    """
    if isinstance(adjacencies, torch.Tensor):
        device = adjacencies.device
        adj = adjacencies.detach().cpu().numpy()
    else:
        adj = np.asarray(adjacencies)
    if adj.ndim == 2:
        adj = adj[None]
    if adj.ndim != 3 or adj.shape[-1] != adj.shape[-2]:
        raise ValueError(
            f"adjacencies must be (V,V) or (S,V,V), got {adj.shape}"
        )
    S, V, _ = adj.shape
    live = adj != 0
    counts = np.count_nonzero(live, axis=-1)
    d_max = max(int(counts.max(initial=0)), 1)
    idx = np.zeros((S, V, d_max), np.int32)
    w = np.zeros((S, V, d_max), adj.dtype)
    for s in range(S):
        # row-major: by row, then column
        rows, cols = np.divmod(np.flatnonzero(live[s]), V)
        slot = np.arange(rows.size) - np.searchsorted(rows, rows)
        idx[s, rows, slot] = cols
        w[s, rows, slot] = adj[s, rows, cols]
    deg = adj.sum(axis=-1)
    return (
        to_torch(idx, device=device),
        to_torch(w, device=device),
        to_torch(deg, device=device),
    )


def _snapshot(arr, k):
    """Round k's slice of a leading-snapshot-axis tensor (k % S)."""
    return arr[k % arr.shape[0]]


def neighbor_laplacian(payload, idx_k, w_k, deg_k):
    """lap_i = sum_s w[i,s] payload[idx[i,s]] - deg_i payload_i.

    payload: (V, ...) any trailing shape; idx_k/w_k: (V, d_max), one
    snapshot; deg_k: (V,). Accumulates and returns the Laplacian in
    ``_acc_dtype(payload.dtype)``.
    """
    V = idx_k.shape[0]
    dt = _acc_dtype(payload.dtype)
    pf = payload.to(dt).reshape(V, -1)
    g = pf[idx_k.long()]  # (V, d_max, F)
    lap = -deg_k.to(dt)[:, None] * pf + torch.einsum("vs,vsf->vf", w_k.to(dt), g)
    return lap.reshape(payload.shape)


def gossip_round_reference(
    betas, omegas, idx_k, w_k, deg_k, scale, *, compress=None
):
    """One eq. (20) round from a padded neighbor list.

    betas: (V, L, M); omegas: (V, L, L); scale = gamma / (V C). The
    Laplacian is cast back to the state dtype before the Omega
    contraction, as in the DenseMixer + DCELMRule composition.
    """
    p = _payload(betas, compress)
    lap = neighbor_laplacian(p, idx_k, w_k, deg_k).to(betas.dtype)
    upd = torch.bmm(omegas, lap)
    return (betas + scale * upd).to(betas.dtype)


def elm_gossip_scan(
    betas, omegas, idx, w, deg, scale, *, num_rounds, compress=None,
):
    """num_rounds eq. (20) rounds; round k uses snapshot k % S.

    idx/w: (S, V, d_max), deg: (S, V).
    """
    _check_compress(compress)
    b = betas
    for k in range(num_rounds):
        b = gossip_round_reference(
            b, omegas, _snapshot(idx, k), _snapshot(w, k),
            _snapshot(deg, k), scale, compress=compress,
        )
    return b


def dense_gossip_rounds(
    betas, omegas, adj, deg, scale, *, num_rounds, compress=None
):
    """num_rounds rounds via the dense (V, V) @ (V, L*M) formulation.

    The exact DenseMixer.laplacian + DCELMRule composition; adj/deg
    carry a leading snapshot axis (S, V, V) / (S, V).
    """
    _check_compress(compress)
    V, L, M = betas.shape
    b = betas
    for k in range(num_rounds):
        p = _payload(b.reshape(V, L * M), compress)
        dt = _acc_dtype(p.dtype)
        p = p.to(dt)
        a_k = _snapshot(adj, k).to(dt)
        d_k = _snapshot(deg, k).to(dt)
        lap = (a_k @ p - d_k[:, None] * p).to(b.dtype)
        upd = torch.bmm(omegas, lap.reshape(V, L, M))
        b = (b + scale * upd).to(b.dtype)
    return b
