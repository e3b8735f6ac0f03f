"""Results I/O and profiling utilities."""

from .io import compute_fro, print_summary, save_results, summarize_results
from .profiling import (
    PhaseTimer,
    device_memory_stats,
    memory_mb,
    torch_trace,
    walks_per_second,
)
