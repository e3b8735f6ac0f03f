"""GP inference on GRF graph kernels: exact (Cholesky) for small N, the exact
spectral diffusion GP, iterative CG + SLQ marginal likelihood with
pathwise-conditioning prediction for large N, and variational (SVGP)
classification."""

from . import exact, iterative, params, spectral, svgp
from .iterative import CGSettings, pathwise_predict, summarize_samples
