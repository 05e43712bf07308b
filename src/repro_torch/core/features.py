"""ELM random feature maps (the paper's hidden layer h(x)).

Port of ``repro/core/features.py``. The hidden layer is a frozen random
map h(x) = [g(w_1, b_1, x), ..., g(w_L, b_L, x)], shared by all nodes
(paper Algorithm 1, step 1). ``ACTIVATIONS`` is the one activation
registry: the plain versions of the fused kernels apply these callables,
and the CUDA kernels (``csrc/elm_common.cuh``) implement the same five
functions by name.

The random draw takes a ``torch.Generator`` in place of a JAX key. The
two frameworks give different numbers for the same seed, so tests carry
the JAX draw across with ``utils/convert.py`` instead.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.utils.device import resolve_device

Activation = Callable[[torch.Tensor], torch.Tensor]

# name -> elementwise g. "rbf" is not listed: it is not an
# affine-then-nonlinearity map and has its own FeatureMap class.
ACTIVATIONS: dict[str, Activation] = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sin": torch.sin,
    "identity": lambda x: x,
}


def promote_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (jnp.matmul's rule; torch's
    own matmul refuses mixed dtypes)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def valid_activations() -> tuple[str, ...]:
    """All activation names accepted by make_random_features."""
    return tuple(ACTIVATIONS) + ("rbf",)


@dataclasses.dataclass(frozen=True)
class RandomFeatureMap:
    """Affine-then-nonlinearity random feature map.

    Attributes:
      weights: (D, L) input-to-hidden weights w_l (columns).
      bias: (L,) hidden biases b_l.
      activation: name of g (a key of ``ACTIVATIONS``).
    """

    weights: torch.Tensor
    bias: torch.Tensor
    activation: str = "sigmoid"

    def __post_init__(self):
        if self.activation not in ACTIVATIONS:
            raise ValueError(
                f"unknown activation {self.activation!r}; "
                f"valid: {sorted(ACTIVATIONS)} "
                "(gaussian hidden nodes are RBFFeatureMap, not a "
                "RandomFeatureMap activation)"
            )

    @property
    def in_dim(self) -> int:
        return self.weights.shape[0]

    @property
    def num_features(self) -> int:
        return self.weights.shape[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """x: (..., D) -> H: (..., L)."""
        z = promote_matmul(x, self.weights)
        return ACTIVATIONS[self.activation](z + self.bias.to(z.dtype))


def rbf_squared_dists(
    x: torch.Tensor, centers: torch.Tensor,
    centers_sq: torch.Tensor | None = None,
) -> torch.Tensor:
    """||x - c||^2 for all centers via ||x||^2 - 2 x.c^T + ||c||^2.

    One (..., L) result from a single (..., D) x (D, L) matmul, never
    the (..., L, D) broadcast. Clamped at zero: the expansion can go
    slightly negative in floating point when x is near a center.
    """
    dt = torch.promote_types(x.dtype, centers.dtype)
    x, centers = x.to(dt), centers.to(dt)
    if centers_sq is None:
        centers_sq = torch.sum(centers * centers, dim=-1)
    x_sq = torch.sum(x * x, dim=-1, keepdim=True)
    cross = x @ centers.T
    return torch.clamp(x_sq - 2.0 * cross + centers_sq, min=0.0)


@dataclasses.dataclass(frozen=True)
class RBFFeatureMap:
    """Gaussian / RBF hidden nodes g(w, b, x) = exp(-b ||x - w||^2)."""

    centers: torch.Tensor  # (L, D)
    gamma: torch.Tensor  # (L,), positive

    @property
    def in_dim(self) -> int:
        return self.centers.shape[1]

    @property
    def num_features(self) -> int:
        return self.centers.shape[0]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        d2 = rbf_squared_dists(x, self.centers)
        return torch.exp(-self.gamma.to(d2.dtype) * d2)


def _uniform(generator, shape, lo, hi, dtype, device):
    gen_dev = generator.device if generator is not None else device
    u = torch.rand(shape, generator=generator, device=gen_dev, dtype=dtype)
    return (lo + (hi - lo) * u).to(device)


def make_random_features(
    generator: torch.Generator | None,
    in_dim: int,
    num_features: int,
    activation: str = "sigmoid",
    *,
    scale: float = 1.0,
    dtype=torch.float32,
    device=None,
):
    """Sample the paper's uniform random hidden layer.

    U(-scale, scale) weights and U(0, scale) biases (common ELM
    practice, Huang et al. 2006); for "rbf", U(-scale, scale) centers
    and U(0.05, 1) widths. ``generator`` may live on any device; the
    map's tensors go to ``device`` (default ``cuda``).
    """
    dev = resolve_device(device)
    if activation == "rbf":
        centers = _uniform(
            generator, (num_features, in_dim), -scale, scale, dtype, dev
        )
        gamma = _uniform(generator, (num_features,), 0.05, 1.0, dtype, dev)
        return RBFFeatureMap(centers=centers, gamma=gamma)
    if activation not in ACTIVATIONS:
        raise ValueError(
            f"unknown activation {activation!r}; "
            f"valid: {sorted(valid_activations())}"
        )
    w = _uniform(generator, (in_dim, num_features), -scale, scale, dtype, dev)
    b = _uniform(generator, (num_features,), 0.0, scale, dtype, dev)
    return RandomFeatureMap(weights=w, bias=b, activation=activation)
