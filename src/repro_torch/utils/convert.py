"""Carry the JAX package's objects across to the port, through numpy.

The port does not re-implement JAX's threefry draws. A test or a script
that wants both packages to compute the same thing draws its inputs
once (with numpy, or with the JAX package) and builds the port's
objects from the numpy arrays here.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.consensus import Graph
from repro_torch.core.features import RandomFeatureMap, RBFFeatureMap
from repro_torch.utils.bridge import to_torch


def feature_map_from_numpy(W, b, activation: str, *, device=None):
    """The port's feature map from ``(W, b, activation)``.

    The fused kernels' convention: for "rbf" pass W = centers^T (D, L)
    and b = gamma (L,).
    """
    Wt = to_torch(W, device=device)
    bt = to_torch(b, device=device)
    if activation == "rbf":
        return RBFFeatureMap(centers=Wt.T.contiguous(), gamma=bt)
    return RandomFeatureMap(weights=Wt, bias=bt, activation=activation)


def graph_from_numpy(adjacency, name: str = "graph") -> Graph:
    """The port's ``Graph`` from a (V, V) numpy adjacency."""
    return Graph(np.array(adjacency, dtype=np.float64), name=name)


def state_from_numpy(betas, omegas, k: int = 0, *, device=None):
    """The port's ``DCELMState`` from numpy (V, L, M) betas and
    (V, L, L) omegas."""
    from repro_torch.core.dc_elm import DCELMState

    return DCELMState(
        betas=to_torch(betas, device=device),
        omegas=to_torch(omegas, device=device),
        k=int(k),
    )
