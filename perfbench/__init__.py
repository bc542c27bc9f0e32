"""The benchmark of gpras_tpu_torch (the PyTorch and CUDA port): see run.py."""
