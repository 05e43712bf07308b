"""Port parity: kernel B4's plain versions, ``predict_map``'s routing
rules, ``node_predict`` and the centralized ELM (repro_torch) against the
JAX package (repro) on the same inputs.

Tolerances: f32 to 1e-5 x max|reference| (the same products summed in
another order). bf16 operands against the JAX Pallas kernel in
interpret mode, which shares the port's policy (f32 feature product,
hidden tile rounded to bf16, beta never quantized): one bf16 ulp
(2^-8) on an element of h where the two f32 sums straddle a rounding
boundary, so 2e-3 x max|reference|. The ridge solves to 1e-4 (f32
Cholesky at cond ~1e2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dc_elm as jdc
from repro.core import elm as jelm
from repro.core import features as jfeat
from repro.kernels import elm_predict_ops as jops
from repro.kernels import elm_predict_ref as jref
from repro.kernels.elm_predict import elm_predict_pallas
from repro_torch.core import dc_elm as tdc
from repro_torch.core import elm as telm
from repro_torch.kernels import elm_predict_ops as tops
from repro_torch.kernels import elm_predict_ref as tref
from repro_torch.utils.bridge import to_numpy, to_torch
from repro_torch.utils.convert import feature_map_from_numpy

ACTS = ("sigmoid", "tanh", "relu", "sin", "identity", "rbf")
CPU = "cpu"


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _t(a):
    return to_torch(np.asarray(a), device=CPU)


def _problem(N, D, L, M, act, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (N, D)).astype(np.float32)
    W = rng.uniform(-1, 1, (D, L)).astype(np.float32)
    b = rng.uniform(0.05 if act == "rbf" else 0.0, 1.0, (L,)).astype(
        np.float32
    )
    beta = rng.standard_normal((L, M)).astype(np.float32)
    return X, W, b, beta


def _jmap(W, b, act):
    if act == "rbf":
        return jfeat.RBFFeatureMap(jnp.asarray(W.T), jnp.asarray(b))
    return jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b), act)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("N", [64, 71])  # 71: ragged against every chunk
def test_predict_plain_matches_reference_f32(act, N):
    X, W, b, beta = _problem(N, 7, 20, 3, act, seed=N)
    want = jref.elm_predict_scan(
        jnp.asarray(X), jnp.asarray(W), jnp.asarray(b), jnp.asarray(beta),
        activation=act, chunk=32,
    )
    got = tref.elm_predict_scan(_t(X), _t(W), _t(b), _t(beta),
                                activation=act, chunk=32)
    _close(to_numpy(got), want, 1e-5)
    got_ref = tref.predict_reference(_t(X), _t(W), _t(b), _t(beta),
                                     activation=act)
    _close(to_numpy(got_ref), want, 1e-5)


@pytest.mark.parametrize("act", ["sigmoid", "relu", "rbf"])
def test_predict_plain_matches_pallas_interpret_bf16(act):
    X, W, b, beta = _problem(45, 8, 16, 4, act, seed=1)
    Xb, Wb = jnp.asarray(X, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16)
    want = elm_predict_pallas(
        Xb, Wb, jnp.asarray(b), jnp.asarray(beta), activation=act,
        interpret=True, block_l=16, block_n=32,
    )
    got = tops.fused_predict(
        to_torch(np.asarray(Xb), device=CPU),
        to_torch(np.asarray(Wb), device=CPU), _t(b), _t(beta),
        activation=act,
    )
    assert got.dtype == torch.float32  # beta f32: never quantized
    _close(to_numpy(got), want, 2e-3)


def test_predict_dtype_chain():
    bf = torch.zeros(1, dtype=torch.bfloat16)
    f32, f64 = torch.zeros(1), torch.zeros(1, dtype=torch.float64)
    assert tref.predict_dtype(bf, bf, bf) == torch.bfloat16
    assert tref.predict_dtype(bf, bf, f32) == torch.float32
    assert tref.predict_dtype(f32, f32, f64) == torch.float64


def test_predict_map_routes_match_reference():
    X, W, b, beta = _problem(12, 5, 9, 2, "tanh", seed=2)
    jm = _jmap(W, b, "tanh")
    tm = feature_map_from_numpy(W, b, "tanh", device=CPU)
    # leading dims are flattened to rows and restored
    X3 = X.reshape(3, 4, 5)
    _close(to_numpy(tops.predict_map(_t(X3), tm, _t(beta))),
           jops.predict_map(jnp.asarray(X3), jm, jnp.asarray(beta)), 1e-5)
    # feature_map=None: x already is the feature matrix
    H = np.asarray(jm(jnp.asarray(X)))
    _close(to_numpy(tops.predict_map(_t(H), None, _t(beta))),
           jops.predict_map(jnp.asarray(H), None, jnp.asarray(beta)), 1e-5)
    # f64 inputs materialize H in f64
    y64 = tops.predict_map(_t(X).double(), tm, _t(beta).double())
    assert y64.dtype == torch.float64
    _close(to_numpy(y64), to_numpy(tm(_t(X)).double() @ _t(beta).double()),
           1e-6)
    # N = 0
    y0 = tops.predict_map(torch.zeros((0, 5)), tm, _t(beta))
    assert tuple(y0.shape) == (0, 2)


def test_node_predict_matches_reference():
    V, L, M = 5, 12, 3
    X, W, b, _ = _problem(33, 6, L, M, "sigmoid", seed=3)
    betas = np.random.default_rng(4).standard_normal((V, L, M)).astype(
        np.float32
    )
    want = jdc.node_predict(_jmap(W, b, "sigmoid"), jnp.asarray(betas),
                            jnp.asarray(X))
    got = tdc.node_predict(feature_map_from_numpy(W, b, "sigmoid",
                                                  device=CPU),
                           _t(betas), _t(X))
    assert tuple(got.shape) == (V, 33, M)
    _close(to_numpy(got), want, 1e-5)


@pytest.mark.parametrize("mode", ["primal", "dual"])
def test_ridge_solve_and_elm_match_reference(mode):
    X, W, b, _ = _problem(40 if mode == "primal" else 10, 4, 16, 1,
                          "sigmoid", seed=5)
    T = np.sin(3 * X[:, :1]).astype(np.float32)
    jm = _jmap(W, b, "sigmoid")
    tm = feature_map_from_numpy(W, b, "sigmoid", device=CPU)
    H = np.asarray(jm(jnp.asarray(X)))
    want = jelm.ridge_solve(jnp.asarray(H), jnp.asarray(T), 2.0, mode=mode)
    got = telm.ridge_solve(_t(H), _t(T), 2.0, mode=mode)
    _close(to_numpy(got), want, 1e-4)
    model = telm.ELM(tm, got)
    _close(to_numpy(model(_t(X))), jelm.ELM(jm, want)(jnp.asarray(X)), 1e-4)
    _close(float(telm.mse(model, _t(X), _t(T[:, 0]))),
           float(jelm.mse(jelm.ELM(jm, want), jnp.asarray(X),
                          jnp.asarray(T[:, 0]))), 1e-4)


def test_train_centralized_fits():
    gen = torch.Generator().manual_seed(0)
    X = torch.rand((256, 1), generator=gen) * 2 - 1
    T = torch.sin(3 * X[:, 0])
    model = telm.train_centralized(gen, X, T, num_features=32, C=100.0)
    assert float(telm.mse(model, X, T)) < 0.5 * float(T.var())
    P, Q = (lambda H: (H.T @ H, H.T @ T[:, None]))(model.feature_map(X))
    _close(to_numpy(telm.solve_from_stats(P, Q, 100.0)),
           to_numpy(model.beta), 1e-3)
