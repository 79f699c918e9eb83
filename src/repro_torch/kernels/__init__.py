"""Hand-written Hopper kernels of the port and their plain versions.

Each subpackage mirrors ``repro.kernels``: ``ops.py`` is the wrapper
(launches the CUDA kernel for CUDA tensors, raises if it cannot, and
counts its launches), ``ref.py`` the plain PyTorch version it is held
against and the only path taken for CPU tensors.  Sources live in
``repro_torch/csrc``; ``build.py`` compiles them.
"""
