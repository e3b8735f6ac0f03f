"""Hand-written CUDA kernels for Hopper (``sm_90a``), each beside its plain
PyTorch version: K1 ``stencil`` (the stencil product), K2 ``gram`` (the two
passes of the fused masked-Gram CG), K3 ``stencil_build`` (ELL → stencil) and
K4 ``walker`` (fused walks → dense step matrices). Importing needs no CUDA;
the kernels are built at first use (see ``_build``)."""

from .walker import sample_dense_step_matrices_cuda, sample_dense_step_matrices_plain
