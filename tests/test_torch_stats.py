"""Port parity: features, the statistics plane and kernel B1's plain
versions (repro_torch) against the JAX package (repro) on the same inputs.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances:

* f32: rtol 1e-5 and an absolute floor of 1e-5 x max|reference| -- the
  two sides sum the same f32 products in another order.
* bf16 operands: both sides round the hidden tile to bf16 before the
  moment products. The JAX Pallas kernel (interpret mode) computes the
  feature product in f32 as the port does, so an element of h can
  differ by one bf16 ulp (2^-8 relative) only where the two f32 sums
  straddle a rounding boundary: 2e-3 x max|reference| bounds that.
* Omega and the ridge solves: 1e-4 relative -- a Cholesky solve in f32
  loses about cond(A) x eps, and these systems have cond ~1e2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeat
from repro.core import stats as jstats
from repro.kernels import elm_stats_ref as jref
from repro.kernels.elm_stats import elm_stats_pallas
from repro_torch.core import features as tfeat
from repro_torch.core import stats as tstats
from repro_torch.kernels import elm_stats_ops
from repro_torch.kernels import elm_stats_ref as tref
from repro_torch.utils.bridge import to_numpy, to_torch
from repro_torch.utils.convert import feature_map_from_numpy

ACTS = ("sigmoid", "tanh", "relu", "sin", "identity", "rbf")
CPU = "cpu"


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _problem(N, D, L, M, act, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    W = rng.uniform(-1, 1, (D, L)).astype(np.float32)
    b = rng.uniform(0.05 if act == "rbf" else 0.0, 1.0, (L,)).astype(
        np.float32
    )
    T = rng.standard_normal((N, M)).astype(np.float32)
    return X, W, b, T


def _t(a):
    return to_torch(a, device=CPU)


# ---------------------------------------------------------------------------
# core/features.py
# ---------------------------------------------------------------------------


def test_activation_registry_matches():
    assert tuple(tfeat.ACTIVATIONS) == tuple(jfeat.ACTIVATIONS)
    assert tfeat.valid_activations() == jfeat.valid_activations()
    z = np.linspace(-4, 4, 101).astype(np.float32)
    for name, g in tfeat.ACTIVATIONS.items():
        _close(to_numpy(g(_t(z))), jfeat.ACTIVATIONS[name](jnp.asarray(z)),
               1e-6)


def test_unknown_activation_names_every_valid_one():
    W, b = torch.zeros(3, 4), torch.zeros(4)
    with pytest.raises(ValueError) as err:
        tfeat.RandomFeatureMap(W, b, "gelu")
    for name in tfeat.ACTIVATIONS:
        assert name in str(err.value)
    with pytest.raises(ValueError, match="rbf"):
        tfeat.make_random_features(None, 3, 4, "gelu", device=CPU)


@pytest.mark.parametrize("act", ACTS)
def test_feature_map_matches_reference(act):
    X, W, b, _ = _problem(37, 5, 12, 1, act, seed=1)
    if act == "rbf":
        jmap = jfeat.RBFFeatureMap(jnp.asarray(W.T), jnp.asarray(b))
    else:
        jmap = jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b), act)
    tmap = feature_map_from_numpy(W, b, act, device=CPU)
    _close(to_numpy(tmap(_t(X))), jmap(jnp.asarray(X)), 1e-5)


def test_rbf_squared_dists_clamped_and_matching():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((6, 4)).astype(np.float32)
    x = np.concatenate([c, rng.standard_normal((5, 4)).astype(np.float32)])
    got = to_numpy(tfeat.rbf_squared_dists(_t(x), _t(c)))
    assert got.min() >= 0.0
    _close(got, jfeat.rbf_squared_dists(jnp.asarray(x), jnp.asarray(c)), 1e-5)


def test_make_random_features_distribution():
    gen = torch.Generator().manual_seed(0)
    fm = tfeat.make_random_features(gen, 16, 256, "tanh", device=CPU)
    assert fm.weights.shape == (16, 256) and fm.bias.shape == (256,)
    assert -1 <= float(fm.weights.min()) and float(fm.weights.max()) <= 1
    assert 0 <= float(fm.bias.min()) and float(fm.bias.max()) <= 1
    rbf = tfeat.make_random_features(gen, 16, 64, "rbf", device=CPU)
    assert rbf.centers.shape == (64, 16)
    assert 0.05 <= float(rbf.gamma.min()) and float(rbf.gamma.max()) <= 1


# ---------------------------------------------------------------------------
# kernels/elm_stats_ref.py (kernel B1's plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("N", [64, 77])  # 77: ragged against every chunk
def test_stats_plain_matches_reference_f32(act, N):
    X, W, b, T = _problem(N, 9, 24, 3, act, seed=N)
    want = jref.elm_stats_scan(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(b), jnp.asarray(T),
        activation=act, chunk=32,
    )
    for fn in (tref.elm_stats_reference, tref.elm_stats_scan):
        kw = {"chunk": 32} if fn is tref.elm_stats_scan else {}
        P, Q = fn(_t(X), _t(W), _t(b), _t(T), activation=act, **kw)
        _close(to_numpy(P), want[0], 1e-5)
        _close(to_numpy(Q), want[1], 1e-5)
        np.testing.assert_array_equal(to_numpy(P), to_numpy(P).T)


@pytest.mark.parametrize("act", ["sigmoid", "sin", "rbf"])
def test_stats_plain_matches_pallas_interpret_bf16(act):
    """bf16 operands against the TPU kernel's own policy (f32 feature
    product, bf16 hidden tile, f32 targets never quantized)."""
    X, W, b, T = _problem(50, 8, 16, 2, act, seed=3)
    Xb = jnp.asarray(X, jnp.bfloat16)
    Wb = jnp.asarray(W, jnp.bfloat16)
    P_want, Q_want = elm_stats_pallas(
        Xb, Wb, jnp.asarray(b), jnp.asarray(T), activation=act,
        interpret=True, block_l=16, block_n=32,
    )
    P, Q = tref.elm_stats_scan(
        to_torch(np.asarray(Xb), device=CPU),
        to_torch(np.asarray(Wb), device=CPU), _t(b), _t(T),
        activation=act, chunk=32,
    )
    _close(to_numpy(P), P_want, 2e-3)
    _close(to_numpy(Q), Q_want, 2e-3)


def test_stats_plain_matches_pallas_interpret_f32():
    X, W, b, T = _problem(45, 7, 20, 3, "tanh", seed=4)
    want = elm_stats_pallas(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(b), jnp.asarray(T),
        activation="tanh", interpret=True, block_l=16, block_n=32,
    )
    got = elm_stats_ops.fused_moments(
        _t(X), _t(W), _t(b), _t(T), activation="tanh"
    )
    _close(to_numpy(got[0]), want[0], 1e-5)
    _close(to_numpy(got[1]), want[1], 1e-5)


def test_stats_node_axis_equals_per_node():
    """The port's leading node axis is the reference's vmap."""
    V = 3
    X, W, b, T = _problem(V * 20, 6, 10, 2, "sigmoid", seed=5)
    Xn, Tn = X.reshape(V, 20, 6), T.reshape(V, 20, 2)
    fmap = feature_map_from_numpy(W, b, "sigmoid", device=CPU)
    P, Q = tstats.raw_moments(_t(Xn), _t(Tn), fmap)
    jmap = jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b))
    Pj, Qj = jax.vmap(lambda x, t: jstats.raw_moments(x, t, jmap))(
        jnp.asarray(Xn), jnp.asarray(Tn)
    )
    _close(to_numpy(P), Pj, 1e-5)
    _close(to_numpy(Q), Qj, 1e-5)


def test_raw_moments_f64_and_nonfusable_route_materialize():
    X, W, b, T = _problem(30, 4, 6, 2, "sigmoid", seed=6)
    fmap = feature_map_from_numpy(W, b, "sigmoid", device=CPU)
    P, Q = tstats.raw_moments(_t(X).double(), _t(T).double(), fmap)
    assert P.dtype == torch.float64
    P2, Q2 = tstats.raw_moments(_t(X), _t(T), lambda x: fmap(x))
    H = fmap(_t(X))
    _close(to_numpy(P2), to_numpy(H.T @ H), 1e-6)
    _close(to_numpy(P), to_numpy(P2), 1e-6)


# ---------------------------------------------------------------------------
# core/stats.py solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("C,V", [(1.0, 1), (0.5, 8), (4.0, 16)])
def test_omega_and_solves_match_reference(C, V):
    X, W, b, T = _problem(40, 6, 16, 3, "sigmoid", seed=7)
    jmap = jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b))
    P, Q = jstats.raw_moments(jnp.asarray(X), jnp.asarray(T), jmap)
    Pt, Qt = to_torch(np.asarray(P), device=CPU), to_torch(
        np.asarray(Q), device=CPU
    )
    _close(to_numpy(tstats.omega_from_moments(Pt, C, V)),
           jstats.omega_from_moments(P, C, V), 1e-4)
    om, b0 = tstats.finalize_moments(Pt, Qt, C, V)
    om_j, b0_j = jstats.finalize_moments(P, Q, C, V)
    _close(to_numpy(b0), b0_j, 1e-4)
    _close(to_numpy(tstats.ridge_solve_moments(Pt, Qt, C)),
           jstats.ridge_solve_moments(P, Q, C), 1e-4)
    A = torch.eye(16, dtype=torch.float64) / (V * C) + Pt.double()
    om64 = tstats.omega_from_moments(Pt.double(), C, V)
    np.testing.assert_allclose(to_numpy(A @ om64), np.eye(16), atol=1e-9)


def test_accum_dtype_and_fusable_params():
    f32, bf, f64 = torch.zeros(1), torch.zeros(1, dtype=torch.bfloat16), \
        torch.zeros(1, dtype=torch.float64)
    assert tstats.accum_dtype(f32, bf) == torch.float32
    assert tstats.accum_dtype(bf, bf) == torch.float32
    assert tstats.accum_dtype(f32, f64) == torch.float64
    W, b = np.ones((3, 4), np.float32), np.ones(4, np.float32)
    W_, b_, act = tstats.fusable_params(
        feature_map_from_numpy(W, b, "rbf", device=CPU)
    )
    assert act == "rbf" and W_.shape == (3, 4)
    assert tstats.fusable_params(lambda x: x) is None


def test_hidden_moments_bf16_keeps_targets():
    rng = np.random.default_rng(8)
    H = rng.uniform(0, 1, (33, 8)).astype(np.float32)
    T = rng.standard_normal((33, 2)).astype(np.float32)
    Hb = jnp.asarray(H, jnp.bfloat16)
    P_j, Q_j = jstats.hidden_moments(Hb, jnp.asarray(T))
    P, Q = tstats.hidden_moments(to_torch(np.asarray(Hb), device=CPU), _t(T))
    assert P.dtype == Q.dtype == torch.float32
    _close(to_numpy(P), P_j, 1e-5)
    _close(to_numpy(Q), Q_j, 1e-5)
