"""Port parity for the whole slice: Algorithm 1 end to end (features ->
fused moments -> Omega -> eq. (20) rounds -> node prediction) in
repro_torch against the JAX package on the same inputs, plus the
paper's guarantees on the port's own run.

Tolerances: Omega and the seeds to 1e-4 x max|reference| (f32 Cholesky,
cond ~1e2 here); betas after the rounds and the predictions to 1e-4 x
max|reference| (summation-order drift over the rounds).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core import dc_elm as jdc
from repro.core import engine as jengine
from repro.core import features as jfeat
from repro_torch.core import dc_elm as tdc
from repro_torch.core import engine as tengine
from repro_torch.core import features as tfeat
from repro_torch.core import stats as tstats
from repro_torch.utils.bridge import to_numpy, to_torch
from repro_torch.utils.convert import feature_map_from_numpy, graph_from_numpy

CPU = "cpu"


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _t(a):
    return to_torch(np.asarray(a), device=CPU)


def _data(V, Ni, D, M, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (V, Ni, D)).astype(np.float32)
    A = rng.standard_normal((D, M)).astype(np.float32) / np.sqrt(D)
    T = np.sin(2 * X @ A).astype(np.float32)
    Xq = rng.uniform(-1, 1, (25, D)).astype(np.float32)
    return X, T, Xq


@pytest.mark.parametrize(
    "V,Ni,D,L,M,act,mixer",
    [
        (16, 20, 5, 16, 2, "sigmoid", "neighbor"),  # dense arm on the CPU
        (64, 12, 4, 8, 2, "tanh", "neighbor"),      # fused round loop
        (8, 30, 3, 12, 1, "rbf", "dense"),
    ],
)
def test_algorithm1_matches_reference(V, Ni, D, L, M, act, mixer):
    X, T, Xq = _data(V, Ni, D, M, seed=V + L)
    rng = np.random.default_rng(1)
    W = rng.uniform(-1, 1, (D, L)).astype(np.float32)
    b = rng.uniform(0.05, 1, (L,)).astype(np.float32)
    jmap = (jfeat.RBFFeatureMap(jnp.asarray(W.T), jnp.asarray(b))
            if act == "rbf" else
            jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b), act))
    tmap = feature_map_from_numpy(W, b, act, device=CPU)
    graph = jcons.build("hypercube" if V in (16, 64) else "ring", V)
    C, rounds = 4.0 / V, 30
    gamma = graph.default_gamma()

    jeng = jengine.simulated_dc_elm(graph, C, mixer=mixer)
    js = jeng.stream_init(X_nodes=jnp.asarray(X), T_nodes=jnp.asarray(T),
                          feature_map=jmap)
    jb, _ = jeng.run(js.betas, js.omegas, gamma, rounds)
    jy = jdc.node_predict(jmap, jb, jnp.asarray(Xq))

    teng = tengine.simulated_dc_elm(
        graph_from_numpy(graph.adjacency), C, mixer=mixer, device=CPU
    )
    ts = teng.stream_init(X_nodes=_t(X), T_nodes=_t(T), feature_map=tmap)
    _close(to_numpy(ts.omegas), js.omegas, 1e-4)
    _close(to_numpy(ts.betas), js.betas, 1e-4)
    tb, _ = teng.run(ts.betas, ts.omegas, gamma, rounds)
    _close(to_numpy(tb), jb, 1e-4)
    ty = tdc.node_predict(tmap, tb, _t(Xq))
    _close(to_numpy(ty), jy, 1e-4)


def test_simulate_path_matches_reference_and_converges():
    V, Ni, D, L, M = 16, 24, 4, 12, 2
    X, T, _ = _data(V, Ni, D, M, seed=7)
    rng = np.random.default_rng(2)
    W = rng.uniform(-1, 1, (D, L)).astype(np.float32)
    b = rng.uniform(0, 1, (L,)).astype(np.float32)
    jmap = jfeat.RandomFeatureMap(jnp.asarray(W), jnp.asarray(b))
    tmap = feature_map_from_numpy(W, b, "sigmoid", device=CPU)
    graph = jcons.build("hypercube", V)
    C, rounds = 1.0 / V, 150
    gamma = graph.default_gamma()

    jstate, jP, jQ = jdc.simulate_init_raw(jnp.asarray(X), jnp.asarray(T),
                                           jmap, C)
    jfinal, _ = jdc.simulate_run(jstate, graph, gamma, C, rounds)
    tstate, P, Q = tdc.simulate_init_raw(_t(X), _t(T), tmap, C)
    _close(to_numpy(P), jP, 1e-5)
    _close(to_numpy(Q), jQ, 1e-5)
    tfinal, _ = tdc.simulate_run(tstate, graph_from_numpy(graph.adjacency),
                                 gamma, C, rounds)
    assert tfinal.k == rounds
    _close(to_numpy(tfinal.betas), jfinal.betas, 1e-4)

    # Thm. 2: every node approaches the centralized beta* (f64 stats)
    f64 = tfeat.RandomFeatureMap(tmap.weights.double(), tmap.bias.double())
    P64, Q64 = tstats.raw_moments(_t(X).double(), _t(T).double(), f64)
    bstar = tdc.centralized_from_node_stats(P64, Q64, C)
    _close(to_numpy(bstar),
           jdc.centralized_from_node_stats(jP, jQ, C), 1e-4)
    d0 = float(tdc.distance_to(tstate.betas.double(), bstar))
    d1 = float(tdc.distance_to(tfinal.betas.double(), bstar))
    assert d1 < 0.1 * d0
    assert float(tdc.consensus_error(tfinal.betas)) < float(
        tdc.consensus_error(tstate.betas)
    )
    _close(float(tdc.consensus_error(tfinal.betas)),
           float(jdc.consensus_error(jfinal.betas)), 1e-3)
    # eq. (12): the gradient sum stays at f32 round-off of its terms
    for s in (tstate, tfinal):
        s64 = tdc.DCELMState(s.betas.double(), s.omegas.double())
        gs = tdc.gradient_sum(s64, P64, Q64, C)
        terms = V * C * torch.bmm(P64, s64.betas).abs().sum()
        assert float(gs.abs().max()) < 1e-4 * float(terms)


def test_simulate_train_runs_on_generator_draw():
    gen = torch.Generator().manual_seed(3)
    X = torch.rand((8, 16, 3), generator=gen) * 2 - 1
    T = torch.sin(2 * X[..., :1])
    graph = graph_from_numpy(jcons.build("ring", 8).adjacency)
    fmap, final, traces = tdc.simulate_train(
        gen, X, T, num_features=10, C=0.5, graph=graph, num_iters=20,
        trace_fn=lambda b: tdc.consensus_error(b),
    )
    assert tuple(final.betas.shape) == (8, 10, 1)
    assert tuple(traces.shape) == (20,)
    assert float(traces[-1]) < float(traces[0])
    assert isinstance(fmap, tfeat.RandomFeatureMap)
