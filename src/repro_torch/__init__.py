"""PyTorch/CUDA port of the DC-ELM reproduction (package ``repro``).

The layout mirrors ``src/repro/`` module for module, so each ported
function sits at the same path as its JAX counterpart. The port imports
``torch`` only: it never imports ``jax`` or anything of ``repro``.

Every kernel that the JAX package wrote in Pallas for the TPU is a CUDA
C++ kernel here (``csrc/``), built with ``nvcc`` at first use and bound
with ``ctypes`` (``kernels/_build.py``). Each kernel wrapper launches its
kernel for CUDA tensors and takes the plain PyTorch version beside it
only for tensors on the CPU. Entry points that create tensors put them
on ``cuda`` unless the caller passes ``device="cpu"``; without a GPU and
without an explicit CPU device they raise (``utils/device.py``).
"""
