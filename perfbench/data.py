"""Inputs of every cell, made on the device from ``--seed``.

The recipes are ``chip_smoke.py``'s (``training_set``: bench's
``_make_data_hard`` problem plus three smooth responses; ``synthetic_fields``:
a 192 x 256 sloped bed with a dry ridge, flooded by twelve smooth
patterns), drawn from ``torch.Generator``s on the device instead of numpy's,
so the same seed gives the same inputs on one device. Every draw has a
fixed size, so every seed gives the same amount of work.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

N_PATTERNS = 12


def generator(seed: int, stream: str, device: str) -> torch.Generator:
    """An independent generator for one named stream of one seed."""
    tag = sum((i + 1) * ord(c) for i, c in enumerate(stream))
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + tag) % (1 << 62))


def training_set(cfg: dict, seed: int, device: str) -> tuple[Tensor, Tensor]:
    """x (N, D) standard normal; y (N, P): mode 0 a sum of three sines of
    the first three inputs, mode p >= 1 sin(x[:, :3] @ w_p), each with
    noise of standard deviation 0.1. float32 on ``device``."""
    n, d, p = cfg["n_train"], cfg["input_dim"], cfg["hf_modes"]
    g = generator(seed, "train", device)
    x = torch.randn((n, d), generator=g, device=device, dtype=torch.float64)
    w = torch.randn((p, 3), generator=g, device=device, dtype=torch.float64)
    eps = torch.randn((n, p), generator=g, device=device, dtype=torch.float64)
    ys = [torch.sin(x[:, 0]) + 0.5 * torch.sin(2.0 * x[:, 1]) + 0.4 * torch.sin(4.0 * x[:, 2])]
    ys += [torch.sin(x[:, :3] @ w[i]) for i in range(1, p)]
    y = torch.stack(ys, dim=1) + 0.1 * eps
    return x.float().contiguous(), y.float().contiguous(), w


def hyperparameters(cfg: dict, w: Tensor) -> dict[str, Tensor]:
    """The configuration's fixed per-mode hyperparameters, (P, ...) float32,
    in the program's log space."""
    hp = cfg["hyperparameters"]
    d, p = cfg["input_dim"], cfg["hf_modes"]
    rule = hp["lengthscales"]
    if rule["rule"] == "constant":
        ls = torch.full((p, d), float(rule["value"]), dtype=torch.float64)
    elif rule["rule"] == "active-clip":
        # mode 0: the stated lengthscales; mode p: 3 / |w| clipped to the
        # range on the active inputs, the nuisance value on the others
        lo, hi = rule["range"]
        act = rule["active"]
        ls = torch.full((p, d), float(rule["nuisance"]), dtype=torch.float64)
        ls[0, :act] = torch.tensor(rule["mode0"], dtype=torch.float64)
        for i in range(1, p):
            ls[i, :act] = torch.clamp(3.0 / w[i].abs().cpu(), lo, hi)
    else:
        raise ValueError(f"unknown lengthscale rule {rule['rule']!r}")
    dev = w.device
    return {"log_variance": torch.full((p,), math.log(hp["variance"]), device=dev),
            "log_lengthscales": torch.log(ls).float().to(dev),
            "log_noise_variance": torch.full((p,), math.log(hp["noise_variance"]), device=dev)}


def inducing_points(cfg: dict, x: Tensor, seed: int) -> Tensor:
    """M distinct training inputs chosen from the seed: the sparse model's
    inducing points, made by the benchmark so both sides get the same."""
    g = generator(seed, "inducing", str(x.device))
    idx = torch.randperm(x.shape[0], generator=g, device=x.device)[:cfg["n_inducing"]]
    return x.index_select(0, torch.sort(idx).values).contiguous()


def terrain(cfg: dict, device: str) -> tuple[Tensor, Tensor, Tensor]:
    """(elevation (cells,), dry ridge mask (cells,), patterns (12, cells),
    HF patterns (12, cells)) of the grid, float64; no randomness."""
    gy, gx = torch.meshgrid(torch.linspace(0, 1, cfg["grid"][0], dtype=torch.float64,
                                           device=device),
                            torch.linspace(0, 1, cfg["grid"][1], dtype=torch.float64,
                                           device=device), indexing="ij")
    ridge = ((gy - 0.8).abs() < 0.03).reshape(-1)
    elev = (4.0 * gx + 2.0 * gy).reshape(-1) + 30.0 * ridge
    k = torch.arange(N_PATTERNS, device=device)
    patterns = (torch.sin(((k % 4) + 1)[:, None, None] * math.pi * gx)
                * torch.cos(((k // 4) + 1)[:, None, None] * math.pi * gy)).reshape(N_PATTERNS, -1)
    hf_patterns = patterns + 0.2 * torch.roll(patterns, 1, dims=0) * gx.reshape(-1)
    return elev, ridge, patterns, hf_patterns


def fields(cfg: dict, seed: int, stream: str, n_events: int, device: str,
           hf: bool = True) -> tuple[Tensor, Tensor | None, Tensor]:
    """LF (and HF) water-surface fields (events, cells), float64 on
    ``device``: the elevation plus, off the ridge, the positive part of 3 +
    the events' pattern amplitudes (HF: their tanh, on the HF patterns)."""
    elev, ridge, patterns, hf_patterns = terrain(cfg, device)
    g = generator(seed, stream, device)
    amps = torch.randn((n_events, N_PATTERNS), generator=g, device=device, dtype=torch.float64)
    amps = amps / (1.0 + torch.arange(N_PATTERNS, device=device))
    wet = (~ridge).to(torch.float64)
    lf = elev + wet * torch.clamp_min(3.0 + amps @ patterns, 0.0)
    hf_f = elev + wet * torch.clamp_min(3.0 + torch.tanh(amps) @ hf_patterns, 0.0) if hf else None
    return lf, hf_f, elev
