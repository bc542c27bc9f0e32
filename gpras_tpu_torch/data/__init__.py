"""Host-side (CPU) data layer: HEC-RAS/HMS file I/O, builders, parquet replay."""
