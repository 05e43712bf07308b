"""Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries are built at first use into ``_build/`` beside
this package (listed in ``.gitignore``), under a name that carries a
hash of the sources, so an edited source is never served a stale build.
``build`` starts one ``nvcc`` per source at once and waits for all.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

#: activation name -> id of ``csrc/elm_common.cuh``'s ElmActivation
ACT_IDS = {
    "sigmoid": 0, "tanh": 1, "relu": 2, "sin": 3, "identity": 4, "rbf": 5,
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: the C entry points of each library and their argument types (each
#: returns the CUDA error code of its launch as an int)
SIGNATURES = {
    "elm_stats": {
        "elm_stats_launch": [_P] * 6 + [_I] * 7 + [_P],
    },
    "elm_gossip": {
        "elm_gossip_round_launch": [_P] * 6 + [_I] * 4 + [_F, _I, _P],
    },
    "elm_predict": {
        "elm_predict_launch": [_P] * 5 + [_I] * 6 + [_P],
    },
}

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels are built from csrc/ at first use"
        )
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.

    Returns the compiler's output (ptxas register and spill report) per
    library built now. Raises ``RuntimeError`` naming every source that
    failed.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode == 0:
            os.replace(tmp, target)
        else:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def require_cuda(kernel: str, *tensors: torch.Tensor) -> torch.device:
    """The common CUDA device of ``tensors``; raises otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{kernel} launches a CUDA kernel: every operand must lie "
                f"on one CUDA device (got {[str(x.device) for x in tensors]})"
            )
    return dev


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device`` as a raw handle."""
    return torch.cuda.current_stream(device).cuda_stream
