"""gpras_tpu_torch — the PyTorch + CUDA port of ``gpras_tpu``.

The JAX package ``gpras_tpu`` is the reference; this package grows beside it
with the same module layout and public names, so each counterpart is found by
path (``gpras_tpu/gp/exact_cg.py`` -> ``gpras_tpu_torch/gp/exact_cg.py``).
Plain tensor code is PyTorch; each Pallas kernel of the reference becomes a
CUDA C++ kernel written for Hopper (``csrc/``), built with nvcc at first use.

Ported so far: the exact GP — training (``GPRAS.fit``: the dense,
Hutchinson and CG engines, the warm-start protocol; the cold fit
``gp/coldfit.fit_exact``) and serving (checkpoint format, kernel zoo, dense
and matrix-free batched-CG posteriors, EOF preprocessing and the bucketed
``PosteriorPredictor``); SGPR, ``GPRAS``'s default backend, with k-means
inducing points; SVGP (minibatch and streamed natural-gradient fits);
``HmsPreProcessor``; the whole optimizer zoo (``fit/optimizers.FITTERS``);
the flood-verification metrics (``metrics``) and the accuracy north stars
(``accuracy``); the pipeline's ``run`` path (``pipeline.Config``, the data
layer and its parquet replay, ``pipeline.pipeline``, cross-validation and
``python -m gpras_tpu_torch``); the run-generation tooling (flow and plan
files, ``RasModel``'s run creation, SST fetch, event selection, the run
maker, ``select-events`` and ``make-runs``). The distributed layer is still
to come (ROADMAP.md, queue A). Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU.

Import rule: this package imports ``torch`` and ``numpy`` and NEVER ``jax``,
nor ``gpras_tpu`` (whose ``__init__`` imports jax). The machine that runs the
port on the GPU has no JAX installed; tests/test_torch_no_jax.py holds the
package to this in a fresh interpreter.
"""

__version__ = "0.1.0"

__all__ = ["GPRAS", "PreProcessor", "HmsPreProcessor", "PosteriorPredictor", "__version__"]

_LAZY = {
    "GPRAS": ("gpras_tpu_torch.gp.model", "GPRAS"),
    "PreProcessor": ("gpras_tpu_torch.eof.preprocessor", "PreProcessor"),
    "HmsPreProcessor": ("gpras_tpu_torch.eof.preprocessor", "HmsPreProcessor"),
    "PosteriorPredictor": ("gpras_tpu_torch.gp.serving", "PosteriorPredictor"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
