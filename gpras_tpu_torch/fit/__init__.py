"""Optimizers for GP training losses (port of ``gpras_tpu.fit``)."""

from gpras_tpu_torch.fit.optimizers import (  # noqa: F401
    FITTERS,
    adam_fit,
    adadelta_fit,
    de_fit,
    fit,
    lbfgs_fit,
    multi_start_fit,
    three_stage_fit,
    two_stage_fit,
)
