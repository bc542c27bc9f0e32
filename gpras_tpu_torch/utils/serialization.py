"""Pickle-free artifact serialization: flat pytrees of arrays -> one .npz file.

Verbatim port of ``gpras_tpu/utils/serialization.py`` (numpy only), so a
checkpoint written by either package loads in the other: a JSON manifest of
scalars/strings plus named numpy arrays in a single ``.npz``, loadable with
``allow_pickle=False``.
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any

import numpy as np

_MANIFEST_KEY = "__manifest__"


def save_artifact(path: str | Path, meta: dict[str, Any], arrays: dict[str, np.ndarray]) -> None:
    """Write ``meta`` (JSON-serializable) and named arrays to ``path`` (.npz)."""
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    manifest = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    payload[_MANIFEST_KEY] = manifest
    buf = io.BytesIO()
    np.savez(buf, **payload)
    Path(path).write_bytes(buf.getvalue())


def load_artifact(path: str | Path) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """Read (meta, arrays) back; arrays load with allow_pickle=False."""
    with np.load(Path(path), allow_pickle=False) as data:
        meta = json.loads(bytes(data[_MANIFEST_KEY]).decode())
        arrays = {k: data[k] for k in data.files if k != _MANIFEST_KEY}
    return meta, arrays
