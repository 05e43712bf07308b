"""Roofline terms of one consensus round (port of the gossip-round model
of ``repro/analysis/roofline.py``).

The constants are one H100 SXM's published peaks (f32 outside the
tensor cores, HBM3). They cancel out of the relative comparisons this
model is used for (``elm_gossip_ops.prefers_dense``).
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # f32 FLOP/s, non-tensor
HBM_BW = 3.35e12  # bytes/s


def gossip_round_terms(
    V: int, d_max: int, L: int, M: int, *, itemsize: int = 4,
    dense: bool = False,
) -> dict:
    """Roofline terms for one eq. (20) consensus round.

    Every node forms lap_i over ``d_max`` neighbors (``V`` fan-in on the
    ``dense=True`` matmul formulation) and contracts it against Omega_i,
    the 2 V L^2 M flops both formulations share. Memory traffic is the
    state in and out, the Omegas, and the neighbor lists (or the dense
    adjacency); ``gather_bytes`` is the neighbor-gather volume a fused
    round keeps on chip.
    """
    fanin = V if dense else d_max
    flops = 2.0 * V * fanin * L * M + 2.0 * V * L * L * M
    state = itemsize * (2.0 * V * L * M + V * L * L)
    lists = itemsize * V * V if dense else 2.0 * itemsize * V * d_max
    gather_bytes = itemsize * V * fanin * L * M
    t_compute = flops / PEAK_FLOPS
    t_memory = (state + lists) / HBM_BW
    return {
        "flops": flops,
        "hbm_bytes": state + lists,
        "gather_bytes": gather_bytes,
        "t_compute": t_compute,
        "t_memory": t_memory,
        "t_round": max(t_compute, t_memory),
    }
