"""Dispatch of the fused gossip rounds by device, and the dense-arm model.

Port of ``repro/kernels/elm_gossip_ops.py``. ``fused_gossip_rounds``
launches kernel B2 once per round for f32 state on the card; CPU tensors
and non-f32 state take the plain version
(``elm_gossip_ref.elm_gossip_scan``), as the reference does off the TPU
and for non-f32 state.

``prefers_dense`` decides, from the roofline model of one round, when
the dense (V, V) @ (V, L*M) round is modeled no slower than the
neighbor gather; ``mixers.NeighborMixer`` then takes the dense program.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.roofline import gossip_round_terms
from repro_torch.kernels.elm_gossip_ref import elm_gossip_scan

#: slack on the card: the neighbor arm must beat the dense round by this
#: factor before it is preferred. The TPU's value, not yet calibrated on
#: the H100.
DENSE_SLACK_CUDA = 1.25

#: slack on the CPU, where the dense round is a BLAS GEMM near peak and
#: the gather runs ~4-5x below it (the reference's measured value)
DENSE_SLACK_CPU = 5.0


def prefers_dense(
    V: int, d_max: int, L: int, M: int, *, device, slack: float | None = None
) -> bool:
    """True when the dense round is modeled no slower than the neighbor
    round, within ``slack`` (default by ``device``'s type).

    The two arms move the same state and Omega bytes, so the choice is
    the compute term: the dense round spends 2 V^2 L M extra flops on
    zero edges, which matters once it rivals the shared 2 V L^2 M Omega
    term.
    """
    if slack is None:
        cuda = torch.device(device).type == "cuda"
        slack = DENSE_SLACK_CUDA if cuda else DENSE_SLACK_CPU
    tn = gossip_round_terms(V, d_max, L, M)["t_compute"]
    td = gossip_round_terms(V, d_max, L, M, dense=True)["t_compute"]
    return td <= slack * tn


def laplacian_prefers_dense(V: int, d_max: int) -> bool:
    """Laplacian-only arm choice (no Omega term): the gather wins only
    on genuinely sparse graphs."""
    return 2 * d_max >= V


def fused_gossip_rounds(
    betas, omegas, idx, w, deg, scale, *, num_rounds, compress=None,
):
    """num_rounds eq. (20) rounds over padded neighbor lists.

    betas (V, L, M), omegas (V, L, L), idx/w (S, V, d_max), deg (S, V);
    round k mixes with snapshot k % S; scale = gamma / (V C).
    """
    if betas.is_cuda and betas.dtype == torch.float32:
        from repro_torch.kernels.elm_gossip import elm_gossip_cuda

        return elm_gossip_cuda(
            betas, omegas, idx, w, deg, scale,
            num_rounds=num_rounds, compress=compress,
        )
    return elm_gossip_scan(
        betas, omegas, idx, w, deg, scale,
        num_rounds=num_rounds, compress=compress,
    )
