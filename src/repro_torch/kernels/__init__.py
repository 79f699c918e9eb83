"""Hand-written Hopper kernels of the port and their plain versions.

Each subpackage mirrors ``repro.kernels``: ``ops.py`` is the wrapper
(launches the CUDA kernel for CUDA tensors, raises if it cannot, and
counts its launches), ``ref.py`` the plain PyTorch version it is held
against and the only path taken for CPU tensors.  Sources live in
``repro_torch/csrc``; ``build.py`` compiles them.

The public library, as ``repro.kernels`` exports it: ``acam_apply``
(kernel D), ``crossbar_matmul`` (E), ``nldpe_matmul_int8`` and
``encode_int8`` (G), ``fused_crossbar_acam``, ``fused_linear_acam`` and
``logdomain_flash_attention`` (B, C), ``flash_attention`` (F) and
``paged_attention`` (A).
"""
from .acam_activation.ops import acam_apply
from .crossbar_vmm.ops import crossbar_matmul
from .dual_compute.ops import (fused_crossbar_acam, fused_linear_acam,
                               logdomain_flash_attention)
from .flash_attention.ops import flash_attention
from .nldpe_qmatmul.ops import encode_int8, nldpe_matmul_int8
from .paged_attention.ops import paged_attention
