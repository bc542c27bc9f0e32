"""Query-sharded posterior prediction over a mesh axis.

Port of ``gpras_tpu/parallel/ppredict.py``: each rank serves its slice of
the queries through the fitted model's own ``GPRAS.predict`` (whichever
backend and cache it has, the factors held whole on every rank), with no
collective until the slices are gathered.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from gpras_tpu_torch.parallel.mesh import _all_gather, _device, _index, _size


def sharded_predict(mesh: DeviceMesh, model, x_query, axis: str = "i"):
    """Multi-mode posterior (means, variances), each (S, P) as
    ``GPRAS.predict`` returns them, with the S query rows split over
    ``axis``. ``model`` is a fitted ``GPRAS`` and ``x_query`` (S, D) the whole
    query set, the same on every rank; every rank returns the whole result.
    S must divide by the axis size (pad with arbitrary rows and slice, as
    ``gp/serving.py``'s bucketing does)."""
    xq = np.asarray(x_query)
    s = xq.shape[0]
    d = _size(mesh, axis)
    if s % d != 0:
        raise ValueError(f"query count {s} not divisible by mesh axis {d}")
    rows = s // d
    r0 = _index(mesh, axis) * rows
    mean, var = model.predict(xq[r0:r0 + rows])
    dev = _device(mesh)
    both = torch.as_tensor(np.stack([mean, var]), device=dev).transpose(0, 1)  # (rows, 2, P)
    whole = _all_gather(both, mesh, axis).cpu().numpy()
    return whole[:, 0], whole[:, 1]
