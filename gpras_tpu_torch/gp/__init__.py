"""GP model core: exact GP (dense and matrix-free), the high-level model, serving."""
