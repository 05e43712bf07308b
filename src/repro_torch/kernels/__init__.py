"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

Per kernel: ``<name>_ref.py`` holds the plain version, ``<name>.py`` the
ctypes wrapper that launches the CUDA kernel, and ``<name>_ops.py`` the
dispatcher that picks between them by the device of its inputs.
"""
