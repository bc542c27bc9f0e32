"""S3 helpers, gated on the optional boto3 dependency.

A copy of ``gpras_tpu/utils/s3_utils.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Capability parity with the reference's s3 layer (gpras/utils/s3_utils.py:16-93):
a session factory with retry/timeouts, regex key listing with pagination, and
bytes/file upload/download. boto3 is optional: without it every entry point
raises a clear ImportError, and the module surface stays importable for the
rest of the framework.
"""

from __future__ import annotations

import re
from pathlib import Path

try:  # pragma: no cover - boto3 is optional
    import boto3
    from botocore.config import Config as BotoConfig

    HAS_BOTO3 = True
except ImportError:
    boto3 = None
    BotoConfig = None
    HAS_BOTO3 = False


def _require_boto3():
    if not HAS_BOTO3:
        raise ImportError(
            "boto3 is required for S3 access but is not installed.")


def get_client(max_attempts: int = 3, connect_timeout: int = 10,
               read_timeout: int = 60):
    """S3 client with standard-mode retries and timeouts
    (reference s3_utils.py:16-33)."""
    _require_boto3()
    cfg = BotoConfig(
        retries={"max_attempts": max_attempts, "mode": "standard"},
        connect_timeout=connect_timeout,
        read_timeout=read_timeout,
    )
    return boto3.session.Session().client("s3", config=cfg)


def split_uri(uri: str) -> tuple[str, str]:
    if not uri.startswith("s3://"):
        raise ValueError(f"Not an S3 URI: {uri}")
    bucket, _, key = uri[5:].partition("/")
    return bucket, key


def list_keys_regex(client, bucket: str, prefix: str,
                    pattern: str) -> list[str]:
    """Paginated listing filtered by regex (reference s3_utils.py:36-58)."""
    rx = re.compile(pattern)
    keys: list[str] = []
    paginator = client.get_paginator("list_objects_v2")
    for page in paginator.paginate(Bucket=bucket, Prefix=prefix):
        for obj in page.get("Contents", []):
            if rx.search(obj["Key"]):
                keys.append(obj["Key"])
    return keys


def download_bytes(client, uri: str) -> bytes:
    bucket, key = split_uri(uri)
    return client.get_object(Bucket=bucket, Key=key)["Body"].read()


def download_file(client, uri: str, local_path: str | Path) -> str:
    """Download to a local path, creating parent dirs (reference s3_utils.py:86)."""
    bucket, key = split_uri(uri)
    local_path = Path(local_path)
    local_path.parent.mkdir(parents=True, exist_ok=True)
    client.download_file(bucket, key, str(local_path))
    return str(local_path)


def upload_bytes(client, data: bytes, uri: str) -> None:
    bucket, key = split_uri(uri)
    client.put_object(Bucket=bucket, Key=key, Body=data)


def upload_file(client, local_path: str | Path, uri: str) -> None:
    bucket, key = split_uri(uri)
    client.upload_file(str(local_path), bucket, key)
