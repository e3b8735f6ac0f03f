"""graphgp_tpu_torch: the PyTorch and CUDA port of graphgp_tpu.

Graph random-feature Gaussian processes on one NVIDIA H100. This package
keeps the JAX package's module names, so each module's counterpart is easy to
find; it imports torch, numpy and scipy, never JAX or the JAX package. The
stencil product (K1), the fused masked-Gram CG passes (K2) and the ELL →
stencil build (K3) are CUDA kernels written by hand for ``sm_90a``
(``csrc/``), each beside its plain PyTorch version (``cuda_kernels/``). Entry points run on the card unless the caller
passes ``device="cpu"``.
"""

from .features import DenseFeatures, EllFeatures, StencilFeatures, ell_to_stencil
from .graphs import PackedGraph, pack_csr, pack_dense, pack_laplacian
from .pipeline import blocked_ell_features
from .walker import (
    WalkConfig,
    WalkLog,
    dense_step_matrices,
    sample_dense_step_matrices,
    sample_walk_log,
)

__version__ = "0.1.0"
