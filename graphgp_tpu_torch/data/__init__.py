"""Synthetic graph + field generators and the loader of shipped dataset
files (numpy and scipy)."""

from .synthetic import GENERATORS, generate
