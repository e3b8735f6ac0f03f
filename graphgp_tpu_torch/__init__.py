"""graphgp_tpu_torch: the PyTorch and CUDA port of graphgp_tpu.

Graph random-feature Gaussian processes on one NVIDIA H100. This package
keeps the JAX package's module names, so each module's counterpart is easy to
find; it imports torch, numpy and scipy, never JAX or the JAX package. The
stencil product (K1), the fused masked-Gram CG passes (K2), the ELL → stencil
build (K3) and the fused walk → dense step-matrix sampler (K4) are CUDA
kernels written by hand for ``sm_90a`` (``csrc/``), each beside its plain
PyTorch version (``cuda_kernels/``). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""

from .features import (
    DenseFeatures,
    EllFeatures,
    LogFeatures,
    StencilFeatures,
    ell_to_stencil,
    with_transpose,
)
from .graphs import (
    CsrGraph,
    PackedGraph,
    csr_graph,
    generate_noisy_samples,
    laplacian,
    normalized_laplacian,
    normalized_laplacian_csr,
    pack_csr,
    pack_dense,
    pack_laplacian,
    packed_to_dense,
)
from .kernels import (
    diffusion_kernel,
    fast_diffusion_grf_kernel,
    fast_general_grf_kernel,
    feature_matrix_kernel,
    general_pofm_feature_matrix,
    gram_from_phi,
    grf_kernel_unbiased,
    step_matrices_for_adjacency,
)
from .modulators import diffusion_modulator, free_modulator_init, geometric_modulator
from .pipeline import blocked_ell_features
from .walker import (
    WalkConfig,
    WalkLog,
    dense_step_matrices,
    fused_phi,
    sample_dense_step_matrices,
    sample_walk_log,
)

__version__ = "0.1.0"
