"""Flood-verification metric suite."""

from gpras_tpu_torch.metrics.metrics import (  # noqa: F401
    compute_event_metrics,
    export_metric_summary,
)
