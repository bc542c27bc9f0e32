"""Raster-transform helpers for RAS plan-HDF precipitation grids.

A copy of ``gpras_tpu/utils/spatial_utils.py`` (the port may not import the
JAX package, whose ``__init__`` imports jax).

Parity with the reference's ``gpras/utils/spatial_utils.py:9-15``, which builds
an affine transform from the plan-HDF precip raster attributes; without
rasterio/affine we return the (upper_left, pixel_size, shape)
triple our rasterizer (gpras_tpu_torch.data.geometry.rasterize_polygon) consumes.
"""

from __future__ import annotations

from typing import Any


def ras_hdf_precip_grid(attrs: dict[str, Any]) -> tuple[tuple[float, float], float,
                                                        tuple[int, int]]:
    """((left, top), cellsize, (rows, cols)) from plan-HDF precip attrs."""
    return ((float(attrs["Raster Left"]), float(attrs["Raster Top"])),
            float(attrs["Raster Cellsize"]),
            (int(attrs["Raster Rows"]), int(attrs["Raster Cols"])))
