"""Compute ops: kernel Gram builders, Cholesky/solves, fused CUDA matvecs."""
