"""SST event-data fetch: parallel S3 download of per-event HMS DSS files ->
one tidy parquet.

A copy of ``gpras_tpu/pipeline/sst_events.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Capability parity with production/pre_processing/get_sst_events.py:15-130:
threaded (25-worker) download of each event's ``SST.dss``, extraction of the
PRECIP-CUM / PRECIP-EXCESS / FLOW series for a target element, per-event
try/except-continue robustness, and a single parquet with columns
(event_id, datetime, precip-cum, precip-excess, inflow) — the input schema of
``EventSelection``. Gated on boto3 + hecdss (or an injected DSS fake).
"""

from __future__ import annotations

import tempfile
from concurrent.futures import ThreadPoolExecutor, as_completed
from pathlib import Path

import numpy as np
import pandas as pd


def extract_event_series(dss_path: str, element: str) -> pd.DataFrame | None:
    """One event's (precip-cum, precip-excess, inflow) frame from its DSS."""
    from gpras_tpu_torch.data.dss import open_dss

    dss = open_dss(dss_path)
    catalog = list(dss.get_catalog())

    def series(c_part: str) -> pd.Series | None:
        hits = [p for p in catalog if p.B == element and p.C == c_part]
        if not hits:
            return None
        rec = dss.get(str(hits[0]))
        return pd.Series(np.asarray(rec.values), index=pd.to_datetime(rec.times))

    try:
        precip_cum = series("PRECIP-CUM")
        precip_exc = series("PRECIP-EXCESS")
        inflow = series("FLOW")
    finally:
        if hasattr(dss, "close"):
            dss.close()  # one native handle per event under the thread pool
    if inflow is None:
        return None
    df = pd.DataFrame({"inflow": inflow})
    df["precip-cum"] = precip_cum if precip_cum is not None else 0.0
    df["precip-excess"] = precip_exc if precip_exc is not None else 0.0
    df = df.reset_index().rename(columns={"index": "datetime"})
    return df


def get_sst_events(
    event_ids: list[int],
    s3_prefix: str,
    element: str,
    out_parquet: str | Path,
    max_workers: int = 25,
) -> pd.DataFrame:
    """Fetch + extract every event, concat, write parquet
    (reference get_sst_events.py:15-130; failures are logged and skipped)."""
    from gpras_tpu_torch.utils import s3_utils

    client = s3_utils.get_client()
    frames: list[pd.DataFrame] = []
    errors: list[tuple[int, str]] = []

    def fetch(event_id: int) -> pd.DataFrame | None:
        with tempfile.TemporaryDirectory() as tmp:
            local = Path(tmp) / "SST.dss"
            s3_utils.download_file(
                client, f"{s3_prefix}/{event_id}/hydrology/SST.dss", local)
            df = extract_event_series(str(local), element)
            if df is not None:
                df.insert(0, "event_id", event_id)
            return df

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {pool.submit(fetch, e): e for e in event_ids}
        for fut in as_completed(futures):
            event_id = futures[fut]
            try:
                df = fut.result()
                if df is not None:
                    frames.append(df)
            except Exception as e:  # per-event robustness, like the reference
                errors.append((event_id, str(e)))
    if not frames:
        raise RuntimeError(f"No events fetched; errors: {errors[:5]}")
    out = pd.concat(frames, ignore_index=True).sort_values(["event_id", "datetime"])
    out.to_parquet(out_parquet)
    return out
