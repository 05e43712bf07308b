"""Port parity: graphs, kernel B2's plain versions, the mixers and the
engine (repro_torch) against the JAX package (repro) on the same inputs.

Tolerances: one round in f32 to 1e-5 x max|reference| (the same f32
products summed in another order); beta after several rounds to 1e-4 x
max|reference|, the order-of-summation drift compounding over rounds.
The bf16 payload is rounded identically on both sides (round to nearest
even of the same f32 values), so it keeps the f32 tolerances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import consensus as jcons
from repro.core import engine as jengine
from repro.kernels import elm_gossip_ops as jops
from repro.kernels import elm_gossip_ref as jref
from repro.kernels.elm_gossip import elm_gossip_pallas
from repro_torch.core import consensus as tcons
from repro_torch.core import engine as tengine
from repro_torch.core.mixers import DenseMixer, NeighborMixer
from repro_torch.kernels import elm_gossip_ops as tops
from repro_torch.kernels import elm_gossip_ref as tref
from repro_torch.utils.bridge import to_numpy, to_torch
from repro_torch.utils.convert import graph_from_numpy

CPU = "cpu"


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.max(np.abs(want))), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _t(a):
    return to_torch(np.asarray(a), device=CPU)


def _state(V, L, M, seed=0):
    rng = np.random.default_rng(seed)
    betas = rng.standard_normal((V, L, M)).astype(np.float32)
    w = rng.standard_normal((V, L, L)).astype(np.float32)
    omegas = (np.einsum("vlk,vmk->vlm", w, w) / L).astype(np.float32)
    return betas, omegas


def _lists_both(adj):
    j = jref.neighbor_lists(jnp.asarray(adj, jnp.float32))
    t = tref.neighbor_lists(np.asarray(adj, np.float32), device=CPU)
    return j, t


# ---------------------------------------------------------------------------
# core/consensus.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kind,V", [("line", 5), ("ring", 7), ("complete", 6), ("star", 5),
               ("hypercube", 16), ("torus", 12)],
)
def test_graph_builders_identical(kind, V):
    jg, tg = jcons.build(kind, V), tcons.build(kind, V)
    np.testing.assert_array_equal(tg.adjacency, jg.adjacency)
    assert tg.d_max == jg.d_max
    assert tg.default_gamma() == jg.default_gamma()
    np.testing.assert_array_equal(tg.degrees, jg.degrees)


def test_graph_validation_and_paper_fig2():
    assert tcons.paper_fig2().d_max == 2
    with pytest.raises(ValueError, match="undirected"):
        tcons.Graph(np.array([[0.0, 1.0], [0.0, 0.0]]))
    with pytest.raises(ValueError, match="power-of-two"):
        tcons.build("hypercube", 6)


# ---------------------------------------------------------------------------
# kernels/elm_gossip_ref.py (kernel B2's plain versions)
# ---------------------------------------------------------------------------


def test_neighbor_lists_identical():
    adj = jcons.alternating_halves(9)
    adjs = np.stack([g.adjacency for g in adj])
    (ji, jw, jd), (ti, tw, td) = _lists_both(adjs)
    np.testing.assert_array_equal(to_numpy(ti), np.asarray(ji))
    np.testing.assert_array_equal(to_numpy(tw), np.asarray(jw))
    np.testing.assert_array_equal(to_numpy(td), np.asarray(jd))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("compress", [None, "bf16"])
@pytest.mark.parametrize("kind,V", [("hypercube", 16), ("ring", 9),
                                    ("star", 7)])
def test_round_reference_matches(kind, V, compress):
    adj = jcons.build(kind, V).adjacency
    betas, omegas = _state(V, 12, 3, seed=V)
    (ji, jw, jd), (ti, tw, td) = _lists_both(adj)
    scale = 0.7 / V
    want = jref.gossip_round_reference(
        jnp.asarray(betas), jnp.asarray(omegas), ji[0], jw[0], jd[0], scale,
        compress=compress,
    )
    got = tref.gossip_round_reference(
        _t(betas), _t(omegas), ti[0], tw[0], td[0], scale, compress=compress,
    )
    _close(to_numpy(got), want, 1e-5)


@pytest.mark.parametrize("compress", [None, "bf16"])
@pytest.mark.parametrize("time_varying", [False, True])
def test_scan_and_dense_rounds_match(time_varying, compress):
    V, L, M, R = 10, 8, 2, 6
    if time_varying:
        adjs = np.stack([g.adjacency for g in jcons.alternating_halves(V)])
    else:
        adjs = jcons.build("ring", V).adjacency[None]
    betas, omegas = _state(V, L, M, seed=1)
    (ji, jw, jd), (ti, tw, td) = _lists_both(adjs)
    scale = 0.4 / V
    want = jref.elm_gossip_scan(
        jnp.asarray(betas), jnp.asarray(omegas), ji, jw, jd, scale,
        num_rounds=R, compress=compress,
    )
    got = tref.elm_gossip_scan(
        _t(betas), _t(omegas), ti, tw, td, scale, num_rounds=R,
        compress=compress,
    )
    _close(to_numpy(got), want, 1e-4)
    adj32 = adjs.astype(np.float32)
    want_d = jref.dense_gossip_rounds(
        jnp.asarray(betas), jnp.asarray(omegas), jnp.asarray(adj32),
        jnp.asarray(adj32.sum(-1)), scale, num_rounds=R, compress=compress,
    )
    got_d = tref.dense_gossip_rounds(
        _t(betas), _t(omegas), _t(adj32), _t(adj32.sum(-1)), scale,
        num_rounds=R, compress=compress,
    )
    _close(to_numpy(got_d), want_d, 1e-4)
    _close(to_numpy(got_d), to_numpy(got), 1e-4)


def test_plain_round_matches_pallas_interpret():
    adj = jcons.build("hypercube", 8).adjacency
    betas, omegas = _state(8, 16, 2, seed=2)
    (ji, jw, jd), (ti, tw, td) = _lists_both(adj)
    want = elm_gossip_pallas(
        jnp.asarray(betas), jnp.asarray(omegas), ji, jw, jd, 0.05,
        num_rounds=3, block_v=4, interpret=True,
    )
    got = tops.fused_gossip_rounds(
        _t(betas), _t(omegas), ti, tw, td, 0.05, num_rounds=3
    )
    _close(to_numpy(got), want, 1e-4)


def test_payload_mode_validation():
    betas, omegas = _state(4, 4, 1)
    _, (ti, tw, td) = _lists_both(jcons.build("ring", 4).adjacency)
    with pytest.raises(ValueError, match="payload mode"):
        tref.elm_gossip_scan(_t(betas), _t(omegas), ti, tw, td, 0.1,
                             num_rounds=1, compress="int8")


# ---------------------------------------------------------------------------
# kernels/elm_gossip_ops.py, core/mixers.py, core/engine.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "V,d,L,M", [(16, 4, 8, 2), (64, 6, 8, 2), (1024, 10, 128, 8),
                (64, 63, 128, 8)],
)
def test_prefers_dense_matches_reference_slacks(V, d, L, M):
    assert tops.prefers_dense(V, d, L, M, device=CPU) == jops.prefers_dense(
        V, d, L, M, slack=jops.DENSE_SLACK_OFF_TPU
    )
    assert tops.prefers_dense(V, d, L, M, device="cuda") == jops.prefers_dense(
        V, d, L, M, slack=jops.DENSE_SLACK
    )


def test_flagship_point_takes_the_neighbor_kernel():
    """The flagship (hypercube V=1024, L=128, M=8) lands on the kernel
    under both slacks."""
    for dev in (CPU, "cuda"):
        assert not tops.prefers_dense(1024, 10, 128, 8, device=dev)


def _engines(graph, C, mixer, compress=None):
    jeng = jengine.simulated_dc_elm(graph, C, mixer=mixer, compress=compress)
    teng = tengine.simulated_dc_elm(
        graph_from_numpy(graph.adjacency), C, mixer=mixer,
        compress=compress, device=CPU,
    )
    return jeng, teng


@pytest.mark.parametrize("compress", [None, "bf16"])
def test_engine_neighbor_trajectory_matches_reference(compress):
    """V=64, L=8, M=2 clears the CPU slack, so both NeighborMixers run
    the fused round loop; both must match the JAX DenseMixer too."""
    graph = jcons.build("hypercube", 64)
    betas, omegas = _state(64, 8, 2, seed=3)
    C = 2.0
    jeng, teng = _engines(graph, C, "neighbor", compress)
    assert isinstance(teng.mixer, NeighborMixer)
    assert teng.mixer._fused_ok(teng.rule, _t(betas), _t(omegas), 0.05)
    gamma = graph.default_gamma()
    want, _ = jeng.run(jnp.asarray(betas), jnp.asarray(omegas), gamma, 8)
    got, _ = teng.run(_t(betas), _t(omegas), gamma, 8)
    _close(to_numpy(got), want, 1e-4)
    jd, _ = _engines(graph, C, "dense", compress)
    want_d, _ = jd.run(jnp.asarray(betas), jnp.asarray(omegas), gamma, 8)
    _close(to_numpy(got), want_d, 1e-4)


@pytest.mark.parametrize("mixer", ["dense", "neighbor"])
def test_engine_step_and_traces_match_reference(mixer):
    graph = jcons.build("ring", 8)
    betas, omegas = _state(8, 6, 2, seed=4)
    jeng, teng = _engines(graph, 1.5, mixer)
    gamma = graph.default_gamma()
    _close(to_numpy(teng.step(_t(betas), _t(omegas), gamma)),
           jeng.step(jnp.asarray(betas), jnp.asarray(omegas), gamma), 1e-5)
    want, jtr = jeng.run(jnp.asarray(betas), jnp.asarray(omegas), gamma, 5,
                         trace_fn=lambda b: jnp.sum(b * b))
    got, ttr = teng.run(_t(betas), _t(omegas), gamma, 5,
                        trace_fn=lambda b: torch.sum(b * b))
    _close(to_numpy(got), want, 1e-4)
    _close(to_numpy(ttr), jtr, 1e-4)


def test_time_varying_dense_mixer_matches_reference():
    graphs = jcons.alternating_halves(8)
    betas, omegas = _state(8, 6, 2, seed=5)
    jeng = jengine.simulated_dc_elm(graphs, 1.0)
    teng = tengine.simulated_dc_elm(
        [graph_from_numpy(g.adjacency) for g in graphs], 1.0, device=CPU
    )
    assert isinstance(teng.mixer, DenseMixer)
    gamma = 0.9 / max(g.d_max for g in graphs)
    want, _ = jeng.run(jnp.asarray(betas), jnp.asarray(omegas), gamma, 7)
    got, _ = teng.run(_t(betas), _t(omegas), gamma, 7)
    _close(to_numpy(got), want, 1e-4)


@pytest.mark.parametrize("gamma", [0.0, -0.1, 0.25, 1.0])
def test_validate_gamma_rejects_outside_thm2(gamma):
    graph = tcons.build("hypercube", 16)  # d_max = 4: bound 0.25
    eng = tengine.simulated_dc_elm(graph, 1.0, mixer="neighbor", device=CPU)
    betas, omegas = _state(16, 4, 1)
    with pytest.raises(ValueError, match="Thm. 2"):
        eng.run(_t(betas), _t(omegas), gamma, 2)
    with pytest.raises(ValueError, match="Thm. 2"):
        eng.step(_t(betas), _t(omegas), gamma)
    eng.run(_t(betas), _t(omegas), gamma, 1, check_gamma=False)


def test_unknown_mixer_and_compress_rejected():
    graph = tcons.build("ring", 4)
    with pytest.raises(ValueError, match="mixer"):
        tengine.simulated_dc_elm(graph, 1.0, mixer="ppermute", device=CPU)
    with pytest.raises(ValueError, match="compression"):
        tengine.simulated_dc_elm(graph, 1.0, compress="int8", device=CPU)
