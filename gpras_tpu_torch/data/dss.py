"""HEC-DSS gateway: optional native dependency, cleanly gated.

A copy of ``gpras_tpu/data/dss.py`` (the port may not import the JAX
package, whose ``__init__`` imports jax).

The reference reads HMS inflow/precip series and writes grid records through the
``hecdss`` package (Fortran/C HEC-DSS, reference Dockerfile:9-13;
gpras/preprocess.py:745-769, make_ras_runs.py:239-282). That package is not in
this image, so every DSS touch point routes through this module: when ``hecdss``
is importable it is used; otherwise a clear ImportError tells the user what is
missing, and tests inject ``FakeDss`` fixtures through the same seam.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from datetime import datetime
from typing import Any

import numpy as np

try:  # pragma: no cover - exercised only where hecdss is installed
    import hecdss as _hecdss

    HAS_HECDSS = True
except ImportError:
    _hecdss = None
    HAS_HECDSS = False

#: Test seam: assign a class here to stand in for hecdss.HecDss.
_DSS_FACTORY = None


def require_hecdss():
    """Return the HecDss class (real or injected fake), or raise."""
    if _DSS_FACTORY is not None:
        return _DSS_FACTORY
    if HAS_HECDSS:
        return _hecdss.HecDss
    raise ImportError(
        "hecdss is required for HEC-DSS I/O but is not installed in this "
        "environment. Install hecdss, or inject a fake via "
        "gpras_tpu_torch.data.dss.set_dss_factory() for testing."
    )


def set_dss_factory(factory) -> None:
    """Inject a HecDss replacement (tests / alternate backends)."""
    global _DSS_FACTORY
    _DSS_FACTORY = factory


class _RealDssAdapter:
    """Adapts the real hecdss.HecDss to this gateway's 2-arg ``put``.

    hecdss's own signature is ``put(container)`` with the pathname carried on
    ``container.id``; every caller here uses ``put(record, path)`` (the
    FakeDss seam's API), so adapt rather than leak the difference. A shallow
    copy is stored per put so callers may reuse/mutate a template record."""

    def __init__(self, inner):
        self._inner = inner

    def put(self, record, path: str) -> None:
        import copy

        rec = copy.copy(record)
        rec.id = str(path)
        self._inner.put(rec)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def open_dss(path: str):
    cls = require_hecdss()
    inner = cls(str(path))
    if _DSS_FACTORY is not None:
        return inner  # fakes already speak the 2-arg put API
    return _RealDssAdapter(inner)


# ---------------------------------------------------------------------------
# In-memory fake for tests and for environments without the native library
# ---------------------------------------------------------------------------

@dataclass
class FakeRecord:
    """Timeseries or grid record with the attribute surface the builders use."""

    values: np.ndarray | None = None
    times: list[datetime] | None = None
    data: np.ndarray | None = None  # grid
    cellSize: float = 1.0
    numberOfCellsX: int = 0
    numberOfCellsY: int = 0
    lowerLeftCellX: int = 0
    lowerLeftCellY: int = 0
    srsDefinition: str = ""


@dataclass
class FakeCatalogPath:
    """A DSS catalog path with A-F parts (str() gives the /A/B/C/.../ form)."""

    A: str = ""
    B: str = ""
    C: str = ""
    D: str = ""
    E: str = ""
    F: str = ""

    def __str__(self) -> str:
        return f"/{self.A}/{self.B}/{self.C}/{self.D}/{self.E}/{self.F}/"


class FakeDss:
    """Dict-backed HecDss stand-in; register per-file contents via ``stores``."""

    stores: dict[str, dict[str, FakeRecord]] = {}

    def __init__(self, path: str):
        self.path = str(path)
        self._records = dict(self.stores.get(self.path, {}))
        self._paths = [self._parse(p) for p in self._records]

    @staticmethod
    def _parse(p: str) -> FakeCatalogPath:
        parts = (p.strip("/").split("/") + [""] * 6)[:6]
        return FakeCatalogPath(*parts)

    def get_catalog(self):
        return list(self._paths)

    def get(self, path: str) -> FakeRecord:
        return self._records[self._normalize(path)]

    def put(self, record: FakeRecord, path: str) -> None:
        # snapshot: callers commonly mutate one template record per put
        import copy

        snap = copy.copy(record)
        snap.data = np.array(record.data, copy=True) if record.data is not None else None
        self._records[self._normalize(path)] = snap
        self.stores.setdefault(self.path, {})[self._normalize(path)] = snap

    @staticmethod
    def _normalize(path: str) -> str:
        return "/" + str(path).strip("/") + "/"

    def close(self) -> None:
        pass

    @classmethod
    def register(cls, path: str, records: dict[str, Any]) -> None:
        cls.stores[str(path)] = {cls._normalize(k): v for k, v in records.items()}
