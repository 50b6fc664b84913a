"""Sparse GP models of the serving slice (``ClusterGP``, ``CGGP``)."""
