"""HEC-RAS plan (.pXX) files and plan-HDF editing.

A copy of ``gpras_tpu/data/plan_file.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax), with h5py imported where an
HDF file is first written, so the plan text files are made where h5py is
not installed.

Capability parity with the reference's plan layer (gpras/ras/plan.py:14-124):
typed boundary-condition dataclasses carrying their HDF target path, HDF
attribute/data patching (with the bytes-attribute quirk), and a key=value plan
file generated from the captured HEC-RAS 6.50 template
(gpras_tpu_torch/data/plan_template.py — same capture the reference ships as
gpras/ras/static/plan_template.txt) with per-run overrides; a user template
path is accepted for site-specific captures and round-trips byte-exactly.
"""

from __future__ import annotations

from collections.abc import MutableMapping
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class EventCondition:
    """Generic event condition (HDF dataset payload + target path)."""

    data: np.ndarray

    @property
    def path(self) -> str:
        return "Event Conditions"


@dataclass
class FlowHydrographBC(EventCondition):
    """Unsteady flow hydrograph for one BC line
    (reference gpras/ras/plan.py:27-36)."""

    idx: str = ""
    timesteps: np.ndarray | None = None

    @property
    def path(self) -> str:
        return ("/Event Conditions/Unsteady/Boundary Conditions/"
                f"Flow Hydrographs/{self.idx}")


@dataclass
class PrecipitationBC(EventCondition):
    @property
    def path(self) -> str:
        return "/Event Conditions/Meteorology/Precipitation/Values"


@dataclass
class TemperatureBC(EventCondition):
    @property
    def path(self) -> str:
        return "/Event Conditions/Meteorology/Temperature/Values"


def update_hdf_attributes(hdf_path: str, attr_path: str, attrs: dict) -> None:
    """Patch HDF attributes; strings are written as fixed bytes, the only
    encoding HEC-RAS reads back reliably (reference gpras/ras/plan.py:62-72)."""
    import h5py

    with h5py.File(hdf_path, "r+") as f:
        node = f[attr_path].attrs
        for k, v in attrs.items():
            if isinstance(v, str):
                node[k] = np.bytes_(v.encode())
            else:
                node[k] = v


def update_hdf_data(hdf_path: str, data_path: str, data: np.ndarray) -> None:
    """Replace a dataset wholesale (delete + recreate, since shapes may change;
    reference gpras/ras/plan.py:75-81)."""
    import h5py

    with h5py.File(hdf_path, "a") as f:
        if data_path in f:
            del f[data_path]
        f.create_dataset(data_path, data=data)


def default_plan_settings() -> dict[str, str]:
    """The captured HEC-RAS 6.50 defaults as a plain dict (first occurrence
    wins for the one duplicated key; bare flag lines omitted). Prefer
    ``PlanFile()`` which keeps order, duplicates, and flags."""
    from gpras_tpu_torch.data.plan_template import PLAN_TEMPLATE_650

    out: dict[str, str] = {}
    for k, v in PLAN_TEMPLATE_650:
        if v is not None and k not in out:
            out[k] = v
    return out


class _SettingsView(MutableMapping):
    """Dict-like view over the ordered entry list: reads/writes the FIRST
    entry with a given key (HEC-RAS reads the first too), appends new keys
    at the end, skips bare flag lines (value None) on iteration."""

    def __init__(self, entries: list[list[str | None]]):
        self._entries = entries

    def _find(self, key: str) -> int:
        for i, (k, v) in enumerate(self._entries):
            if k == key and v is not None:
                return i
        raise KeyError(key)

    def __getitem__(self, key: str) -> str:
        return self._entries[self._find(key)][1]  # type: ignore[return-value]

    def __setitem__(self, key: str, value: str) -> None:
        try:
            self._entries[self._find(key)][1] = value
        except KeyError:
            self._entries.append([key, value])

    def __delitem__(self, key: str) -> None:
        del self._entries[self._find(key)]

    def __iter__(self):
        seen = set()
        for k, v in self._entries:
            if v is not None and k not in seen:
                seen.add(k)
                yield k

    def __len__(self) -> int:
        return sum(1 for _ in self)


class PlanFile:
    """key=value plan file: captured HEC-RAS 6.50 template + overrides
    (reference gpras/ras/plan.py:84-124 + static/plan_template.txt).

    Internally an ORDERED list of (key, value) entries so a site capture
    round-trips byte-exactly: bare flag lines ("Subcritical Flow") carry
    value ``None``, duplicate keys are preserved ("UNET D2 Cores" appears
    twice in HEC-RAS output), and emission order is HEC-RAS's own.
    ``settings`` is a dict-like view (first occurrence wins)."""

    def __init__(self, settings: dict[str, str] | None = None,
                 template_path: str | Path | None = None):
        if template_path is not None:
            self.entries = self._read_entries(str(template_path))
        else:
            from gpras_tpu_torch.data.plan_template import default_plan_entries

            self.entries = default_plan_entries()
        self.settings = _SettingsView(self.entries)
        if settings is not None:
            self.settings.update(settings)

    @property
    def lines(self) -> list[str]:
        return [(k if v is None else f"{k}={v}") + "\n"
                for k, v in self.entries]

    def emit(self) -> str:
        return "".join(self.lines)

    @staticmethod
    def _read_entries(path: str) -> list[list[str | None]]:
        entries: list[list[str | None]] = []
        with open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                # partition, not split: values may themselves contain '='
                key, sep, value = line.partition("=")
                if not sep:
                    if line:  # bare flag line, e.g. "Subcritical Flow"
                        entries.append([line, None])
                else:
                    entries.append([key, value])
        return entries

    @classmethod
    def from_file(cls, path: str | Path) -> "PlanFile":
        return cls(template_path=path)

    def to_file(self, path: str | Path) -> None:
        with open(path, "w", encoding="ascii", newline="\r\n") as f:
            f.writelines(self.lines)
