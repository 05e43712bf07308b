#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout (the script finds ``src/repro_torch``
beside itself). It needs one CUDA device and ``nvcc``; without a CUDA
device, or outside a checkout, it exits non-zero before printing any
result. Phases, in order:

0. Build every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all at once) and print ptxas' register and spill report.
1. Hold each kernel against its plain PyTorch version on the card, at
   the flagship shapes and at a ragged shape: B1 (fused moments) and B4
   (fused predict) for all five activations plus rbf in f32 and bf16,
   B2 (gossip round) with and without the bf16 payload, with one and two
   topology snapshots.
2. Run Algorithm 1 at the flagship configuration through the port's
   entry points (``engine.simulated_dc_elm(hypercube, C,
   mixer="neighbor")``, ``stream_init``, ``run``, ``dc_elm.node_predict``)
   with every launch counter set to 0 just before and read just after,
   then check: each kernel launched; the distance to the centralized
   beta* (f64) falls; the zero-gradient-sum invariant (eq. 12) holds;
   the kernel rounds match the plain rounds on the card; the held-out
   MSE of the node average beside the centralized ELM's.
3. Time each kernel, its plain version, one PyTorch library call for the
   same function where one exists, and the whole of phase 2 by stage, on
   the card; then list the device time by kernel over one main-path run
   (torch.profiler).

The last lines are the card's name and power limit, one JSON line with
every kernel's numbers, and ``{"ok": true, "device": {...}}``. Any failed
check exits 1 without that last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# outside the tensor cores; every kernel of this slice runs f32 FMAs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

# Relative tolerances (max |kernel - plain| / max |plain|; for B2, over
# the largest change the rounds made to beta):
# f32: the same f32 products summed in another order.
# bf16 operands: the hidden tile is rounded to bf16 on both sides, and an
# element can round one bf16 ulp (2^-8) apart where the two f32 feature
# sums straddle a rounding boundary; only rbf, whose distance expansion
# cancels, shows it on the card (largest readings 5.0e-4 for B1, 1.4e-3
# for B4). Each limit is about three times its kernel's reading.
TOL_F32 = 1e-5
TOL_BF16 = {"B1": 1.5e-3, "B4": 4e-3}
# beta after the main path's rounds: f32 summation-order drift compounds.
TOL_ROUNDS = 1e-4
# eq. (12): |sum_i grad u_i| against the size of its terms, with Omega
# from f32 moments (cond(I/VC + P_i) ~ 2e3 at VC = 1).
TOL_GRADIENT_SUM = 1e-4

ACTIVATIONS = ("sigmoid", "tanh", "relu", "sin", "identity", "rbf")


@dataclasses.dataclass(frozen=True)
class Config:
    """The slice's flagship: the consensus flagship's graph and width
    (benchmarks/consensus_bench.py, hypercube V = 1024, L = 128) fed with
    the stats flagship's data shape (benchmarks/stats_bench.py, N = 65536,
    D = 64, M = 8)."""

    hypercube_dim: int = 10  # V = 1024 nodes, d_max = 10
    rows_per_node: int = 64  # N = 65536 rows in all
    in_dim: int = 64
    features: int = 128
    targets: int = 8
    queries: int = 4096
    rounds: int = 200
    # V C = 1 keeps the f32 preconditioners well conditioned: with
    # N_i = 64 < L = 128 each P_i is singular and cond(I/VC + P_i) is
    # ~ VC * lambda_max(P_i).
    C: float = 1.0 / 1024
    # the ragged shape for phase 1: no extent a multiple of any block
    ragged_nodes: int = 37
    ragged_rows: int = 77
    ragged_in_dim: int = 45
    ragged_features: int = 70
    ragged_targets: int = 5
    ragged_queries: int = 1000
    ragged_outputs: int = 99
    time_reps: int = 10
    time_batches: int = 5

    @property
    def nodes(self) -> int:
        return 1 << self.hypercube_dim


class Failures:
    """Collects failed checks; the run exits 1 if any."""

    def __init__(self):
        self.items: list[str] = []

    def check(self, ok: bool, what: str) -> None:
        print(("ok    " if ok else "FAIL  ") + what, flush=True)
        if not ok:
            self.items.append(what)


def rel_err(got, want):
    """(max abs error, that error over max |want|) in f64."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(float(want.double().abs().max()), 1e-30)
    return err, err / scale


def increment_err(got, want, start):
    """(max abs error, that error over max |want - start|) in f64: a
    round's error against the size of what the rounds changed."""
    err = float((got.double() - want.double()).abs().max())
    scale = max(float((want.double() - start.double()).abs().max()), 1e-30)
    return err, err / scale


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 0: build
# ---------------------------------------------------------------------------


def build_kernels():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {len(logs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _uniform(gen, shape, lo, hi, dev):
    import torch

    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)


def stats_inputs(gen, V, N, D, L, M, act, dtype, dev):
    import torch

    X = _uniform(gen, (V, N, D), -1, 1, dev).to(dtype)
    W = _uniform(gen, (D, L), -1, 1, dev).to(dtype)
    b = _uniform(gen, (L,), 0.05 if act == "rbf" else 0.0, 1.0, dev)
    T = torch.randn((V, N, M), generator=gen, device=dev)
    return X, W, b, T


def gossip_inputs(gen, graphs, L, M, dev):
    import numpy as np
    import torch

    from repro_torch.kernels import elm_gossip_ref

    V = graphs[0].num_nodes
    adj = np.stack([g.adjacency for g in graphs]).astype(np.float32)
    idx, w, deg = elm_gossip_ref.neighbor_lists(adj, device=dev)
    betas = torch.randn((V, L, M), generator=gen, device=dev)
    A = torch.randn((V, L, L), generator=gen, device=dev)
    # Omega = (I / VC + P)^-1 at V C = 1, as on the main path: its
    # spectrum lies in (0, 1], and scale = gamma / (V C) with the default
    # gamma moves beta by a share of its own size in each round.
    eye = torch.eye(L, device=dev)
    omegas = torch.cholesky_solve(
        eye.expand(V, L, L), torch.linalg.cholesky(eye + A @ A.mT / L))
    scale = 0.9 / float(deg.max())
    return betas, omegas, idx, w, deg, scale


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------


def gossip_stepwise_err(betas, omegas, idx, w, deg, scale, rounds, compress):
    """B2 against its plain version round by round: round k starts both
    from the plain state after k rounds and uses snapshot k % S.

    The bf16 payload is a step function of beta, so over chained rounds a
    one-ulp f32 difference can flip a payload element by a bf16 ulp; from
    a shared state the two must agree to f32 summation order. Returns the
    largest (max abs error, error over the round's largest increment)."""
    from repro_torch.kernels import elm_gossip, elm_gossip_ref

    worst = (0.0, 0.0)
    x = betas
    for k in range(rounds):
        snap = slice(k % idx.shape[0], k % idx.shape[0] + 1)
        args = (omegas, idx[snap], w[snap], deg[snap], scale)
        got = elm_gossip.elm_gossip_cuda(x, *args, num_rounds=1,
                                         compress=compress)
        want = elm_gossip_ref.elm_gossip_scan(x, *args, num_rounds=1,
                                              compress=compress)
        worst = max(worst, increment_err(got, want, x), key=lambda t: t[1])
        x = want
    return worst


def check_kernels(cfg: Config, dev, fails: Failures) -> dict:
    """Returns the max abs error per kernel at the main path's case."""
    import torch

    from repro_torch.core import consensus
    from repro_torch.kernels import (
        elm_gossip,
        elm_gossip_ref,
        elm_predict,
        elm_predict_ref,
        elm_stats,
        elm_stats_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(1234)
    V, Ni, D, L, M = (cfg.nodes, cfg.rows_per_node, cfg.in_dim,
                      cfg.features, cfg.targets)
    stats_shapes = {
        "flagship": (V, Ni, D, L, M),
        "ragged": (cfg.ragged_nodes, cfg.ragged_rows, cfg.ragged_in_dim,
                   cfg.ragged_features, cfg.ragged_targets),
    }
    predict_shapes = {
        "flagship": (cfg.queries, D, L, V * M),
        "ragged": (cfg.ragged_queries, cfg.ragged_in_dim,
                   cfg.ragged_features, cfg.ragged_outputs),
    }
    main_err = {}
    for shape, (v, n, d, l, m) in stats_shapes.items():
        for act in ACTIVATIONS:
            for dtype in (torch.float32, torch.bfloat16):
                X, W, b, T = stats_inputs(gen, v, n, d, l, m, act, dtype, dev)
                P, Q = elm_stats.elm_stats_cuda(X, W, b, T, activation=act)
                Pr, Qr = elm_stats_ref.elm_stats_reference(
                    X, W, b, T, activation=act)
                tol = TOL_F32 if dtype == torch.float32 else TOL_BF16["B1"]
                (ep, rp), (eq, rq) = rel_err(P, Pr), rel_err(Q, Qr)
                sym = bool(torch.equal(P, P.mT))
                fails.check(
                    rp <= tol and rq <= tol and sym,
                    f"B1 {shape} {act} {str(dtype)[6:]}: P max_abs_err="
                    f"{ep:.3e} rel={rp:.2e}, Q max_abs_err={eq:.3e} "
                    f"rel={rq:.2e} (tol {tol:g}), P symmetric={sym}",
                )
                if shape == "flagship" and act == "sigmoid" and \
                        dtype == torch.float32:
                    main_err["elm_stats"] = max(ep, eq)
    for shape, (n, d, l, m) in predict_shapes.items():
        for act in ACTIVATIONS:
            for dtype in (torch.float32, torch.bfloat16):
                X, W, b, _ = stats_inputs(gen, 1, n, d, l, 1, act, dtype, dev)
                X = X[0]
                beta = torch.randn((l, m), generator=gen, device=dev)
                Y = elm_predict.elm_predict_cuda(X, W, b, beta, activation=act)
                Yr = elm_predict_ref.predict_reference(
                    X, W, b, beta, activation=act)
                tol = TOL_F32 if dtype == torch.float32 else TOL_BF16["B4"]
                e, r = rel_err(Y, Yr)
                fails.check(
                    r <= tol,
                    f"B4 {shape} {act} {str(dtype)[6:]}: max_abs_err={e:.3e} "
                    f"rel={r:.2e} (tol {tol:g})",
                )
                if shape == "flagship" and act == "sigmoid" and \
                        dtype == torch.float32:
                    main_err["elm_predict"] = e
    gossip_graphs = {
        "flagship": [consensus.hypercube(cfg.hypercube_dim),
                     consensus.ring(V)],
        "ragged": [consensus.ring(cfg.ragged_nodes),
                   consensus.star(cfg.ragged_nodes)],
    }
    for shape, graphs in gossip_graphs.items():
        l, m = ((L, M) if shape == "flagship"
                else (cfg.ragged_features, cfg.ragged_targets))
        for S in (1, 2):
            for compress in (None, "bf16"):
                inputs = gossip_inputs(gen, graphs[:S], l, m, dev)
                e, r = gossip_stepwise_err(*inputs, 3, compress)
                fails.check(
                    r <= TOL_F32,
                    f"B2 {shape} S={S} compress={compress} (3 rounds, each "
                    f"from the plain state): max_abs_err={e:.3e} rel to the "
                    f"increment={r:.2e} (tol {TOL_F32:g})",
                )
                if compress is not None:
                    continue
                betas, omegas, idx, w, deg, scale = inputs
                got = elm_gossip.elm_gossip_cuda(
                    betas, omegas, idx, w, deg, scale, num_rounds=3)
                want = elm_gossip_ref.elm_gossip_scan(
                    betas, omegas, idx, w, deg, scale, num_rounds=3)
                e, r = increment_err(got, want, betas)
                fails.check(
                    r <= TOL_F32,
                    f"B2 {shape} S={S} compress=None (3 chained rounds): "
                    f"max_abs_err={e:.3e} rel to the increment={r:.2e} "
                    f"(tol {TOL_F32:g})",
                )
                if shape == "flagship" and S == 1:
                    main_err["elm_gossip"] = e
    return main_err


# ---------------------------------------------------------------------------
# Phase 2: Algorithm 1 at the flagship configuration
# ---------------------------------------------------------------------------


def flagship_data(cfg: Config, seed: int, dev):
    """The hypercube and a synthetic regression: T = sin(2 X A) + 0.05
    noise, X ~ U(-1, 1)."""
    import torch

    from repro_torch.core import consensus, features

    gen = torch.Generator(device=dev).manual_seed(seed)
    V, Ni, D, M = cfg.nodes, cfg.rows_per_node, cfg.in_dim, cfg.targets
    A = torch.randn((D, M), generator=gen, device=dev) / D**0.5
    X = _uniform(gen, (V, Ni, D), -1, 1, dev)
    T = torch.sin(2 * X @ A) + 0.05 * torch.randn(
        (V, Ni, M), generator=gen, device=dev)
    Xq = _uniform(gen, (cfg.queries, D), -1, 1, dev)
    Tq = torch.sin(2 * Xq @ A)
    fmap = features.make_random_features(
        gen, D, cfg.features, "sigmoid", device=dev)
    graph = consensus.hypercube(cfg.hypercube_dim)
    return graph, fmap, X, T, Xq, Tq


def counters():
    from repro_torch.kernels import elm_gossip, elm_predict, elm_stats

    return {
        "elm_stats": elm_stats.elm_stats_cuda,
        "elm_gossip": elm_gossip.elm_gossip_round_cuda,
        "elm_predict": elm_predict.elm_predict_cuda,
    }


def main_path(cfg: Config, dev, graph, fmap, X, T, Xq):
    """Algorithm 1 + node prediction through the port's entry points.

    The graph and the data are set-up and come in built. Returns (engine,
    stream state, final betas, node predictions, seconds per stage)."""
    import torch

    from repro_torch.core import dc_elm, engine

    t0 = time.perf_counter()
    eng = engine.simulated_dc_elm(graph, cfg.C, mixer="neighbor", device=dev)
    t1 = time.perf_counter()
    st = eng.stream_init(X_nodes=X, T_nodes=T, feature_map=fmap)
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    betas, _ = eng.run(st.betas, st.omegas, graph.default_gamma(), cfg.rounds)
    torch.cuda.synchronize(dev)
    t3 = time.perf_counter()
    Y = dc_elm.node_predict(fmap, betas, Xq)
    torch.cuda.synchronize(dev)
    t4 = time.perf_counter()
    stages = dict(engine=t1 - t0, stream_init=t2 - t1, rounds=t3 - t2,
                  node_predict=t4 - t3)
    return eng, st, betas, Y, stages


def run_algorithm1(cfg: Config, seed: int, dev, fails: Failures) -> dict:
    import torch

    from repro_torch.core import dc_elm, elm, features, stats
    from repro_torch.kernels import elm_gossip_ref, elm_predict_ref

    graph, fmap, X, T, Xq, Tq = flagship_data(cfg, seed, dev)
    for fn in counters().values():
        fn.launches = 0
    eng, st, betas, Y, stages = main_path(cfg, dev, graph, fmap, X, T, Xq)
    launches = {name: fn.launches for name, fn in counters().items()}
    print("main path launches: " + json.dumps(launches))
    print("main path stages (s): " + json.dumps(stages))
    for name, n in launches.items():
        fails.check(n > 0, f"{name} launched {n} times on the main path")
    V, L, M = cfg.nodes, cfg.features, cfg.targets
    fails.check(
        tuple(Y.shape) == (V, cfg.queries, M) and bool(torch.isfinite(Y).all())
        and bool(torch.isfinite(betas).all()),
        f"node predictions {tuple(Y.shape)} and betas finite",
    )

    # centralized beta* from f64 moments on the card
    f64 = features.RandomFeatureMap(
        fmap.weights.double(), fmap.bias.double(), fmap.activation)
    P64, Q64 = stats.raw_moments(X.double(), T.double(), f64)
    bstar = dc_elm.centralized_from_node_stats(P64, Q64, cfg.C)
    d0 = float(dc_elm.distance_to(st.betas.double(), bstar))
    d1 = float(dc_elm.distance_to(betas.double(), bstar))
    fails.check(d1 < d0, f"distance to beta*: {d0:.6g} -> {d1:.6g} after "
                         f"{cfg.rounds} rounds")

    for tag, b in (("round 0", st.betas), (f"round {cfg.rounds}", betas)):
        s = dc_elm.DCELMState(b.double(), st.omegas.double())
        gs = dc_elm.gradient_sum(s, P64, Q64, cfg.C)
        terms = float(torch.linalg.norm(
            V * cfg.C * torch.bmm(P64, s.betas), dim=(1, 2)).sum())
        rel = float(torch.linalg.norm(gs)) / terms
        fails.check(rel <= TOL_GRADIENT_SUM,
                    f"gradient sum (eq. 12) at {tag}: |sum| / sum|terms| = "
                    f"{rel:.3e} (tol {TOL_GRADIENT_SUM:g})")

    # the same rounds through the plain version, on the card
    mx = eng.mixer
    plain = elm_gossip_ref.elm_gossip_scan(
        st.betas, st.omegas, mx.neighbor_idx, mx.neighbor_w, mx.degrees,
        mx._scale(eng.rule, graph.default_gamma()), num_rounds=cfg.rounds)
    e, r = rel_err(betas, plain)
    fails.check(r <= TOL_ROUNDS, f"kernel rounds vs plain rounds after "
                                 f"{cfg.rounds}: max_abs_err={e:.3e} "
                                 f"rel={r:.2e} (tol {TOL_ROUNDS:g})")
    wide = betas.permute(1, 0, 2).reshape(L, V * M)
    Yr = elm_predict_ref.predict_reference(
        Xq, fmap.weights, fmap.bias, wide).reshape(cfg.queries, V, M)
    e, r = rel_err(Y, Yr.permute(1, 0, 2))
    fails.check(r <= TOL_F32, f"node_predict vs plain predict: max_abs_err="
                              f"{e:.3e} rel={r:.2e} (tol {TOL_F32:g})")

    node_mse = float(torch.mean((Y - Tq[None]) ** 2))
    Y0 = dc_elm.node_predict(fmap, st.betas, Xq)
    local_mse = float(torch.mean((Y0 - Tq[None]) ** 2))
    central = elm.ELM(fmap, bstar.float())
    central_mse = float(elm.mse(central, Xq, Tq))
    print(f"held-out MSE: node average {node_mse:.6g} after {cfg.rounds} "
          f"rounds (local-only at round 0: {local_mse:.6g}); centralized "
          f"ELM {central_mse:.6g}; zero predictor {float(torch.mean(Tq**2)):.6g}")
    fails.check(node_mse < local_mse, "consensus lowered the held-out MSE")
    return {"launches": launches, "inputs": (graph, fmap, X, T, Xq)}


# ---------------------------------------------------------------------------
# Phase 3: times
# ---------------------------------------------------------------------------


def time_ms(fn, cfg: Config, dev) -> float:
    """Median over batches of the mean device time per call.

    Each batch is queued behind a device-side sleep, so the events time
    the device's work and not the host's enqueue; a 64 MiB write before
    it evicts the L2 cache, as a cold call on the main path finds it."""
    import torch

    flush = torch.empty(16 * 2**20, dtype=torch.float32, device=dev)
    for _ in range(2):
        fn()
    torch.cuda.synchronize(dev)
    means = []
    for _ in range(cfg.time_batches):
        flush.zero_()
        if hasattr(torch.cuda, "_sleep"):
            torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(cfg.time_reps):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / cfg.time_reps)
    return statistics.median(means)


def time_kernels(cfg: Config, dev, inputs) -> dict:
    import torch

    from repro_torch.core import consensus
    from repro_torch.kernels import (
        elm_gossip,
        elm_gossip_ref,
        elm_predict,
        elm_predict_ref,
        elm_stats,
        elm_stats_ref,
    )

    _, fmap, X, T, Xq = inputs
    W, b = fmap.weights, fmap.bias
    V, Ni, D, L, M = (cfg.nodes, cfg.rows_per_node, cfg.in_dim,
                      cfg.features, cfg.targets)
    out = {}

    # B1 at the main path's inputs
    H = elm_stats_ref.hidden_reference(X, W, b, "sigmoid")
    HT = torch.cat([H, T], dim=-1)
    nbytes = 4 * (V * Ni * D + D * L + L + V * Ni * M + V * L * L + V * L * M)
    flops = 2.0 * V * Ni * (D * L + L * (L + 1) / 2 + L * M)
    out["elm_stats"] = dict(
        ms=time_ms(lambda: elm_stats.elm_stats_cuda(X, W, b, T), cfg, dev),
        plain_ms=time_ms(
            lambda: elm_stats_ref.elm_stats_reference(X, W, b, T), cfg, dev),
        library_ms=time_ms(lambda: torch.bmm(H.mT, HT), cfg, dev),
        bound=bound_ms(nbytes, flops),
    )
    del H, HT

    # B2: one round at the main path's shapes
    gen = torch.Generator(device=dev).manual_seed(5)
    betas, omegas, idx, w, deg, scale = gossip_inputs(
        gen, [consensus.hypercube(cfg.hypercube_dim)], L, M, dev)
    dst = torch.empty_like(betas)
    d_max = idx.shape[-1]
    nbytes = 4 * (2 * V * L * M + V * L * L + 2 * V * d_max + V)
    flops = 2.0 * V * d_max * L * M + 2.0 * V * L * L * M
    out["elm_gossip"] = dict(
        ms=time_ms(lambda: elm_gossip.elm_gossip_round_cuda(
            betas, omegas, idx[0], w[0], deg[0], scale, dst), cfg, dev),
        plain_ms=time_ms(lambda: elm_gossip_ref.gossip_round_reference(
            betas, omegas, idx[0], w[0], deg[0], scale), cfg, dev),
        library_ms=None,  # no single PyTorch call forms lap and Omega @ lap
        bound=bound_ms(nbytes, flops),
    )
    del betas, omegas, dst

    # B4 at the main path's readout: (L, V * M)
    beta = torch.randn((L, V * M), generator=gen, device=dev)
    H = elm_stats_ref.hidden_reference(Xq, W, b, "sigmoid")
    Nq, Mw = cfg.queries, V * M
    nbytes = 4 * (Nq * D + D * L + L + L * Mw + Nq * Mw)
    flops = 2.0 * Nq * D * L + 2.0 * Nq * L * Mw
    out["elm_predict"] = dict(
        ms=time_ms(lambda: elm_predict.elm_predict_cuda(Xq, W, b, beta),
                   cfg, dev),
        plain_ms=time_ms(lambda: elm_predict_ref.predict_reference(
            Xq, W, b, beta), cfg, dev),
        library_ms=time_ms(lambda: torch.matmul(H, beta), cfg, dev),
        bound=bound_ms(nbytes, flops),
    )
    return out


def time_main_path(cfg: Config, dev, inputs) -> tuple[float, dict]:
    """Median wall time (ms) of the whole main path and of each stage."""
    totals, stages = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        stages.append(main_path(cfg, dev, *inputs)[-1])
        totals.append(time.perf_counter() - t0)
    per_stage = {k: 1e3 * statistics.median(s[k] for s in stages)
                 for k in stages[0]}
    return 1e3 * statistics.median(totals), per_stage


def profile_main_path(cfg: Config, dev, inputs) -> None:
    """Device time by kernel over one main-path run (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        main_path(cfg, dev, *inputs)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, e.count, e.key))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        print("profile: no device time recorded (not measured)")
        return
    print(f"profile main path: device busy {busy_ms:.3f} ms of "
          f"{wall_ms:.3f} ms wall under the profiler")
    for us, count, key in sorted(rows, reverse=True)[:10]:
        print(f"profile  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


KERNEL_META = {
    "elm_stats": ("src/repro_torch/csrc/elm_stats.cu",
                  "src/repro/kernels/elm_stats.py:296"),
    "elm_gossip": ("src/repro_torch/csrc/elm_gossip.cu",
                   "src/repro/kernels/elm_gossip.py:187"),
    "elm_predict": ("src/repro_torch/csrc/elm_predict.cu",
                    "src/repro/kernels/elm_predict.py:104"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the flagship data and feature draw")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg = Config()
    fails = Failures()

    t_start = time.perf_counter()
    build_kernels()
    print("== phase 1: kernels vs plain versions on the card", flush=True)
    errs = check_kernels(cfg, dev, fails)
    print("== phase 2: Algorithm 1 at the flagship configuration", flush=True)
    result = run_algorithm1(cfg, args.seed, dev, fails)
    print("== phase 3: times", flush=True)
    times = time_kernels(cfg, dev, result["inputs"])
    for name, t in times.items():
        print(f"time {name}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, library {t['library_ms']} ms, bound "
              f"{t['bound'][0]:.4f} ms ({t['bound'][1]})")
    phase2_ms, stage_ms = time_main_path(cfg, dev, result["inputs"])
    print(f"time main path (engine + stream_init + {cfg.rounds} rounds + "
          f"node_predict): median {phase2_ms:.3f} ms over 5 runs; stages "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in stage_ms.items()))
    profile_main_path(cfg, dev, result["inputs"])
    print(f"wall: {time.perf_counter() - t_start:.1f} s")
    if fails.items:
        print(f"{len(fails.items)} check(s) failed:", file=sys.stderr)
        for item in fails.items:
            print("  " + item, file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    kernels = []
    for name, (source, replaces) in KERNEL_META.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": result["launches"][name],
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
            "bound_by": t["bound"][1], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
