"""GP inference on GRF graph kernels: exact (Cholesky) for small N, the exact
spectral diffusion GP, and iterative CG + SLQ marginal likelihood with
pathwise-conditioning prediction for large N."""

from . import exact, iterative, params, spectral
from .iterative import CGSettings, pathwise_predict, summarize_samples
