"""Synthetic datasets with the paper's data characteristics."""
