"""Config-driven orchestration: pipeline, cross-validation, event tooling."""

import sys
import types

__all__ = ["Config", "pipeline"]

_LAZY = {
    "Config": ("gpras_tpu_torch.pipeline.config", "Config"),
}


def __getattr__(name):
    # Lazy re-exports: `from gpras_tpu_torch.pipeline import Config, pipeline` is
    # the documented entry point (docs/migration.md) without importing the
    # full pipeline stack (pandas/h5py) on package import.
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


class _Package(types.ModuleType):
    # `pipeline` the re-exported FUNCTION collides with `pipeline` the
    # submodule: `import gpras_tpu_torch.pipeline.pipeline` makes the import
    # machinery setattr the submodule onto this package, which would shadow
    # the lazy __getattr__ export. A property (with a setter that swallows
    # exactly that binding) keeps the documented surface stable either way.
    @property
    def pipeline(self):
        from gpras_tpu_torch.pipeline.pipeline import pipeline as fn

        return fn

    @pipeline.setter
    def pipeline(self, value):  # the submodule binding at import time
        pass


sys.modules[__name__].__class__ = _Package
