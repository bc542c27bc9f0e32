"""File helpers: names, encoding/newline detection, HDF->DSS grid copy.

A copy of ``gpras_tpu/utils/file_utils.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Parity with the reference's ``gpras/utils/file_utils.py``: filename from
path-or-S3-URI (file_utils.py:15-20), encoding+newline sniffing used to patch
HEC-RAS text files losslessly (file_utils.py:23-36; chardet is not in this image,
so we sniff BOM/UTF-8-validity directly), and the HDF->DSS grid copy helper
(file_utils.py:39-60) gated on the optional ``hecdss`` dependency.
"""

from __future__ import annotations

from pathlib import Path


def get_filename(path: str) -> str:
    """Final component of a local path or S3 URI (reference file_utils.py:15-20)."""
    if path.startswith("s3://"):
        return path.rstrip("/").rsplit("/", 1)[-1]
    return Path(path).name


def detect_file_properties(path: str | Path) -> tuple[str, str]:
    """(encoding, newline) of a text file.

    HEC-RAS text files are ASCII/latin-1 with CRLF line endings; preserving both
    on rewrite matters (flow.py:689-692 writes CRLF explicitly). Sniffs a BOM,
    falls back to UTF-8 validity, then latin-1 (which never fails).
    """
    raw = Path(path).read_bytes()
    if raw.startswith(b"\xef\xbb\xbf"):
        encoding = "utf-8-sig"
    else:
        try:
            raw.decode("utf-8")
            encoding = "utf-8"
        except UnicodeDecodeError:
            encoding = "latin-1"
    if b"\r\n" in raw:
        newline = "\r\n"
    elif b"\r" in raw:
        newline = "\r"
    else:
        newline = "\n"
    return encoding, newline


def hdf_grid_to_dss(
    hdf_path: str | Path,
    hdf_dataset: str,
    template_dss: str | Path,
    out_dss: str | Path,
    path_template: str,
    timestamps: list[str],
) -> None:
    """Copy a (T, rows*cols) HDF grid timeseries into DSS grid records by cloning
    a template record per timestep with the grid flipped north-up
    (reference file_utils.py:39-60). Requires the optional ``hecdss`` package."""
    import numpy as np

    # open_dss (not require_hecdss()): the gateway adapter provides the
    # 2-arg put(record, path) this function uses — raw hecdss.HecDss.put
    # takes only the container
    from gpras_tpu_torch.data.dss import open_dss

    import h5py
    import shutil

    shutil.copy(template_dss, out_dss)
    dss = open_dss(str(out_dss))
    template_path = next(iter(dss.get_catalog()))
    template = dss.get(str(template_path))
    with h5py.File(hdf_path, "r") as f:
        data = f[hdf_dataset][:]
    rows = template.numberOfCellsY
    cols = template.numberOfCellsX
    for t, stamp in enumerate(timestamps):
        record = dss.get(str(template_path))
        record.data = np.flipud(data[t].reshape(rows, cols))
        dss.put(record, path_template.format(stamp=stamp))
    dss.close()
