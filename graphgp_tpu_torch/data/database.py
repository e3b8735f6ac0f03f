"""Dataset files shipped with the repository.

Counterpart of ``_load_csr_npz`` in ``graphgp_tpu/data/database.py``: the
reference's npz layout of CSR triplets (``A_data``, ``A_indices``,
``A_indptr``, ``A_shape``) with node ids ``X`` and targets ``y``, as in
``processed_data/pems_bay.npz``. ``GraphDataLoader`` and the Cora loaders are
not ported yet (ROADMAP Queue 1 item 14).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

Arrays = Tuple[sp.csr_matrix, np.ndarray, np.ndarray]


def _load_csr_npz(path: str) -> Arrays:
    """(adjacency CSR, node ids, targets) from a CSR-triplet npz."""
    with np.load(path) as data:
        adj = sp.csr_matrix(
            (data["A_data"], data["A_indices"], data["A_indptr"]),
            shape=tuple(int(d) for d in data["A_shape"]),
        )
        return adj, np.asarray(data["X"]), np.asarray(data["y"])
