"""The port's package rules: it imports no JAX and nothing of ``repro``;
its entry points refuse to run on the CPU unless asked; its kernel
wrappers launch a kernel or raise on anything but CUDA tensors; the
numpy bridge is lossless. The ``gpu`` tests hold each CUDA kernel against
its plain version on the card and skip without one.

This file imports no JAX at module level, so its ``gpu`` tests also run
on a machine that has only the port's dependencies:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_harness.py``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import consensus, engine, features
from repro_torch.kernels import elm_gossip_ref, elm_predict_ref, elm_stats_ref
from repro_torch.utils import bridge, convert, device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ACTS = ("sigmoid", "tanh", "relu", "sin", "identity", "rbf")


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'repro'))\n"
        "print(len(mods), bad)\n"
        "assert len(mods) >= 20 and not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a machine without CUDA")


def test_entry_points_raise_without_cuda(no_cuda):
    graph = consensus.build("ring", 4)
    calls = [
        lambda: device.resolve_device(),
        lambda: device.resolve_device("cuda"),
        lambda: features.make_random_features(None, 3, 4),
        lambda: engine.simulated_dc_elm(graph, 1.0),
        lambda: engine.simulated_dc_elm(graph, 1.0, mixer="neighbor"),
        lambda: elm_gossip_ref.neighbor_lists(graph.adjacency),
        lambda: bridge.to_torch(np.zeros(3)),
        lambda: convert.feature_map_from_numpy(
            np.zeros((3, 4)), np.zeros(4), "sigmoid"),
        lambda: convert.state_from_numpy(np.zeros((2, 3, 1)),
                                         np.zeros((2, 3, 3))),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert device.resolve_device("cpu") == torch.device("cpu")
    features.make_random_features(None, 3, 4, device="cpu")
    engine.simulated_dc_elm(graph, 1.0, device="cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.elm_gossip import elm_gossip_cuda
    from repro_torch.kernels.elm_predict import elm_predict_cuda
    from repro_torch.kernels.elm_stats import elm_stats_cuda

    X, W, b = torch.zeros(5, 3), torch.zeros(3, 4), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        elm_stats_cuda(X, W, b, torch.zeros(5, 2))
    with pytest.raises(ValueError, match="CUDA"):
        elm_predict_cuda(X, W, b, torch.zeros(4, 2))
    idx, w, deg = elm_gossip_ref.neighbor_lists(
        consensus.build("ring", 4).adjacency, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        elm_gossip_cuda(torch.zeros(4, 3, 1), torch.zeros(4, 3, 3), idx,
                        w.float(), deg.float(), 0.1, num_rounds=1)


def test_bridge_roundtrip_is_lossless():
    jnp = pytest.importorskip("jax.numpy")
    rng = np.random.default_rng(0)
    x = rng.standard_normal((7, 5)).astype(np.float32)
    for dt in (jnp.float32, jnp.bfloat16, jnp.int32):
        a = jnp.asarray(x * 100, dt)
        t = bridge.to_torch(np.asarray(a), device="cpu")
        assert str(t.dtype).endswith(str(np.asarray(a).dtype.name))
        np.testing.assert_array_equal(
            bridge.to_numpy(t), np.asarray(a).astype(bridge.to_numpy(t).dtype)
        )


def test_convert_builds_port_objects():
    rng = np.random.default_rng(1)
    W, b = rng.standard_normal((3, 5)), rng.uniform(0.1, 1, 5)
    rbf = convert.feature_map_from_numpy(W, b, "rbf", device="cpu")
    assert isinstance(rbf, features.RBFFeatureMap)
    assert tuple(rbf.centers.shape) == (5, 3)
    g = convert.graph_from_numpy(consensus.ring(5).adjacency, name="r")
    assert g.d_max == 2 and g.name == "r"
    s = convert.state_from_numpy(np.ones((2, 3, 1)), np.ones((2, 3, 3)),
                                 k=4, device="cpu")
    assert s.num_nodes == 2 and s.k == 4


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want):
    scale = max(float(want.abs().max()), 1e-30)
    return float((got.double() - want.double()).abs().max()) / scale


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_stats_kernel_matches_plain(cuda, act, dtype):
    from repro_torch.kernels.elm_stats import elm_stats_cuda

    g = torch.Generator(device=cuda).manual_seed(0)
    V, N, D, L, M = 3, 77, 37, 70, 5  # ragged against every block
    X = (torch.rand((V, N, D), generator=g, device=cuda) * 2 - 1).to(dtype)
    W = (torch.rand((D, L), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = torch.rand((L,), generator=g, device=cuda) + 0.05
    T = torch.randn((V, N, M), generator=g, device=cuda)
    P, Q = elm_stats_cuda(X, W, b, T, activation=act)
    Pr, Qr = elm_stats_ref.elm_stats_reference(X, W, b, T, activation=act)
    # chip_smoke.py's limits: f32 summation order; bf16 about three times
    # the largest reading on the card (rbf)
    tol = 1e-5 if dtype == torch.float32 else 1.5e-3
    errs = (_rel_err(P, Pr), _rel_err(Q, Qr))
    assert max(errs) < tol, errs
    assert torch.equal(P, P.mT)


@pytest.mark.gpu
@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gpu_predict_kernel_matches_plain(cuda, act, dtype):
    from repro_torch.kernels.elm_predict import elm_predict_cuda

    g = torch.Generator(device=cuda).manual_seed(1)
    N, D, L, M = 133, 37, 70, 99
    X = (torch.rand((N, D), generator=g, device=cuda) * 2 - 1).to(dtype)
    W = (torch.rand((D, L), generator=g, device=cuda) * 2 - 1).to(dtype)
    b = torch.rand((L,), generator=g, device=cuda) + 0.05
    beta = torch.randn((L, M), generator=g, device=cuda)
    Y = elm_predict_cuda(X, W, b, beta, activation=act)
    Yr = elm_predict_ref.predict_reference(X, W, b, beta, activation=act)
    err = _rel_err(Y, Yr)
    assert err < (1e-5 if dtype == torch.float32 else 4e-3), err


@pytest.mark.gpu
@pytest.mark.parametrize("compress", [None, "bf16"])
@pytest.mark.parametrize("snapshots", [1, 2])
def test_gpu_gossip_kernel_matches_plain(cuda, compress, snapshots):
    from repro_torch.kernels.elm_gossip import elm_gossip_cuda

    g = torch.Generator(device=cuda).manual_seed(2)
    V, L, M = 37, 70, 5
    graphs = [consensus.ring(V), consensus.star(V)][:snapshots]
    adj = np.stack([gr.adjacency for gr in graphs]).astype(np.float32)
    idx, w, deg = elm_gossip_ref.neighbor_lists(adj, device=cuda)
    betas = torch.randn((V, L, M), generator=g, device=cuda)
    A = torch.randn((V, L, L), generator=g, device=cuda)
    # Omega = (I / VC + P)^-1 and scale = gamma / (V C) at V C = 1, as on
    # the main path, so each round moves beta by a share of its size.
    eye = torch.eye(L, device=cuda)
    omegas = torch.cholesky_solve(
        eye.expand(V, L, L), torch.linalg.cholesky(eye + A @ A.mT / L))
    scale = 0.9 / float(deg.max())
    # Round by round, each from the plain state: the bf16 payload is a
    # step function of beta, so over chained rounds a one-ulp f32
    # difference can flip a payload element by a bf16 ulp. The error is
    # taken against what the round changed, not against |beta|.
    x = betas
    for k in range(5):
        snap = slice(k % snapshots, k % snapshots + 1)
        args = (omegas, idx[snap], w[snap], deg[snap], scale)
        got = elm_gossip_cuda(x, *args, num_rounds=1, compress=compress)
        want = elm_gossip_ref.elm_gossip_scan(x, *args, num_rounds=1,
                                              compress=compress)
        err = _rel_err(got - x, want - x)
        assert err < 1e-5, (k, err)
        x = want
    if compress is None:
        got = elm_gossip_cuda(betas, omegas, idx, w, deg, scale, num_rounds=5)
        want = elm_gossip_ref.elm_gossip_scan(betas, omegas, idx, w, deg,
                                              scale, num_rounds=5)
        err = _rel_err(got - betas, want - betas)
        assert err < 1e-5, err
