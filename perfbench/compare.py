"""The numbers that decide ``correct``, each held to its limit.

Training: each step's loss (relative gap), the first gradient's norm and
the parameters' change after the followed steps (gap of norms, per leaf,
against the reference's norm of that leaf or of the median leaf, whichever
is larger; the worst leaf counts, and for the change also the median
leaf: ``change_gap_median``, for a model whose worst leaf is one scalar
whose steps cancel). Leaves whose reference gradient is under a thousandth
of the median leaf's move by round-off alone and are left out of the
change.

Serving: the decoded field's largest gap against the reference's largest
departure from the mean field (``mean_gap``), the variance's largest
relative gap over wet cells (``var_gap``, floored at 1e-9 of the largest)
and its root mean square over every compared cell (``var_rms``), and the
dry cells,
which must match exactly. A configuration's limits name the numbers that
decide ``correct``.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

Tensor = torch.Tensor


def _norm(v) -> float:
    return float(torch.linalg.vector_norm(torch.as_tensor(v, dtype=torch.float64).cpu()))


def _leaf_gaps(prog: dict, ref: dict, keep: set[str]) -> list[float]:
    ref_n = {k: _norm(ref[k]) for k in ref}
    med = statistics.median(ref_n.values())
    return [abs(_norm(prog[k]) - ref_n[k]) / max(ref_n[k], med, 1e-300)
            for k in ref if k in keep]


def _leaf_gap(prog: dict, ref: dict, keep: set[str]) -> float:
    return max(_leaf_gaps(prog, ref, keep), default=0.0)


def fit_detail(prog: dict, ref: dict, start: dict) -> list[dict]:
    """Per mode and leaf: the reference's gradient and change norms and the
    program's, for looking into which leaf a gap comes from."""
    rows = []
    for mode, r in ref.items():
        p = prog[mode]
        for k in r["first_grad"] or {}:
            s = torch.as_tensor(start[mode][k], dtype=torch.float64).cpu()
            rows.append({"mode": mode, "leaf": k, "g_ref": _norm(r["first_grad"][k]),
                         "g_prog": _norm(p["first_grad"][k]) if p["first_grad"] else None,
                         "d_ref": _norm(torch.as_tensor(r["params"][k]).double().cpu() - s),
                         "d_prog": _norm(torch.as_tensor(p["params"][k]).double().cpu() - s)})
    return rows


def fit_numbers(prog: dict, ref: dict, start: dict) -> dict[str, float]:
    """``prog`` and ``ref`` hold ``losses`` (the losses of the followed steps
    and the one after), ``first_grad`` and ``params`` (after the followed
    steps), per mode compared; ``start`` the modes' start parameters."""
    loss_gap = grad_gap = change_gap = change_median = 0.0
    for mode, r in ref.items():
        p = prog[mode]
        lp = np.asarray(p["losses"], np.float64)
        lr = np.asarray(r["losses"], np.float64)
        if lp.shape != lr.shape or not np.isfinite(lp).all() or not np.isfinite(lr).all():
            loss_gap = float("inf")
        else:
            loss_gap = max(loss_gap, float(np.max(np.abs(lp - lr) / np.abs(lr))))
        g_ref = r["first_grad"]
        if p["first_grad"] is None or g_ref is None:
            grad_gap = change_gap = change_median = float("inf")
            continue
        grad_gap = max(grad_gap, _leaf_gap(p["first_grad"], g_ref, set(g_ref)))
        g_n = {k: _norm(v) for k, v in g_ref.items()}
        med = statistics.median(g_n.values())
        moving = {k for k, v in g_n.items() if v >= 1e-3 * med}
        s = {k: torch.as_tensor(v, dtype=torch.float64).cpu() for k, v in start[mode].items()}
        d_prog = {k: torch.as_tensor(p["params"][k], dtype=torch.float64).cpu() - s[k]
                  for k in s}
        d_ref = {k: torch.as_tensor(r["params"][k], dtype=torch.float64).cpu() - s[k]
                 for k in s}
        gaps = _leaf_gaps(d_prog, d_ref, moving)
        change_gap = max(change_gap, max(gaps, default=0.0))
        change_median = max(change_median, statistics.median(gaps) if gaps else 0.0)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "change_gap_median": change_median}


def serve_numbers(served: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
                  wet: np.ndarray, elevation: np.ndarray, mean_field: np.ndarray
                  ) -> dict[str, float]:
    """``served``: (field, variance, reference field, reference variance)
    per compared request, (fields, cells) each."""
    gap = scale = var_gap = 0.0
    dry_bad = 0
    sq_var, count = 0.0, 0
    for f, v, fr, vr in served:
        if f.shape != fr.shape or v.shape != vr.shape:
            return {"mean_gap": float("inf"), "var_gap": float("inf"),
                    "dry_cells_off": float(fr.size)}
        dw = np.abs(f[:, wet] - fr[:, wet])
        gap = max(gap, float(np.max(dw)) if np.isfinite(dw).all() else float("inf"))
        scale = max(scale, float(np.max(np.abs(fr[:, wet] - mean_field[wet]))))
        # relative, floored at 1e-9 of the largest: cells whose EOF loadings
        # are all zero (never varying over the fitting events) have none
        floor = 1e-9 * float(np.max(vr[:, wet])) if vr.size else 0.0
        rv = np.abs(v[:, wet] - vr[:, wet]) / (vr[:, wet] + floor)
        var_gap = max(var_gap, float(np.max(rv)) if np.isfinite(rv).all() else float("inf"))
        sq_var += float(np.sum(rv * rv))
        count += rv.size
        dry_bad += int(np.sum(f[:, ~wet] != elevation[~wet]) + np.sum(v[:, ~wet] != 0.0))
    return {"mean_gap": gap / scale if scale > 0 else float("inf"), "var_gap": var_gap,
            "var_rms": (sq_var / max(count, 1)) ** 0.5, "dry_cells_off": float(dry_bad)}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
