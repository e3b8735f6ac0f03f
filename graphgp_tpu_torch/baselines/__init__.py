"""Non-GP baselines (GNN regression)."""

from .gnn import GCN, fit_gcn, gcn_forward, gcn_propagation_matrix
