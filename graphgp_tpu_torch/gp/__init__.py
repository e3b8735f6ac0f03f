"""GP inference on GRF graph kernels: exact (Cholesky) for small N, the exact
spectral diffusion GP, iterative CG + SLQ marginal likelihood with
pathwise-conditioning prediction for large N, variational (SVGP)
classification, and HMC hyperparameter posteriors."""

from . import exact, hmc, iterative, params, spectral, svgp
from .iterative import CGSettings, pathwise_predict, summarize_samples
