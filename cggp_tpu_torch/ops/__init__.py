"""Numerical building blocks: bijectors, kernels, linear algebra, CG and the
hand-written CUDA kernels that replace the JAX package's Pallas kernels."""
