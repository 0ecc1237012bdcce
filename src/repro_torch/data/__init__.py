"""Synthetic data pipelines of the port (numpy, host-sharded, prefetched)."""
