"""Optimizers for GP training losses (port of ``gpras_tpu.fit``)."""
