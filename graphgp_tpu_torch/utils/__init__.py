"""Results I/O and profiling utilities."""

from .io import compute_fro, print_summary, save_results, summarize_results
from .profiling import torch_trace, walks_per_second
