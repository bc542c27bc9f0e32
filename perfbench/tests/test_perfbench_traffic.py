"""Inputs and request streams repeat for one seed and differ for another."""

from __future__ import annotations

import json

import pytest
import torch

from perfbench import data
from perfbench.drivers import serve
from perfbench.tests import tiny

CFG = {**json.loads((tiny.REPO / "perfbench/configs/exact-mat52-n49k.json").read_text()),
       **tiny.TINY}
SEEDS = (2**31 + 11, 5)


def test_training_set_repeats_for_a_seed_and_differs_for_another():
    a = data.training_set(CFG, SEEDS[0], "cpu")
    b = data.training_set(CFG, SEEDS[0], "cpu")
    c = data.training_set(CFG, SEEDS[1], "cpu")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[1], c[1])
    assert a[0].shape == (CFG["n_train"], CFG["input_dim"]) and a[0].dtype == torch.float32


@pytest.mark.parametrize("hf", [True, False])
def test_fields_repeat_and_differ(hf):
    a = data.fields(CFG, SEEDS[0], "requests", 5, "cpu", hf=hf)
    b = data.fields(CFG, SEEDS[0], "requests", 5, "cpu", hf=hf)
    c = data.fields(CFG, SEEDS[1], "requests", 5, "cpu", hf=hf)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert a[0].shape == (5, CFG["grid"][0] * CFG["grid"][1])
    assert (a[1] is None) == (not hf)


def test_request_plan_repeats_sends_each_size_once_a_cycle_and_differs():
    traffic = {"sizes": {"from": 1, "to": 8}, "kept_share": 0.5}
    def take(seed):
        plan = serve.Plan(traffic, 20, seed)
        return [plan.next() for _ in range(8)]

    first = take(SEEDS[0])
    assert first == take(SEEDS[0])
    assert sorted(k for k, _, _ in first) == list(range(1, 9))
    assert first != take(SEEDS[1])
    assert all(0 <= off <= 20 - k for k, off, _ in first)


def test_inducing_points_are_distinct_training_inputs():
    x = data.training_set({**CFG, "n_inducing": 24}, SEEDS[0], "cpu")[0]
    z = data.inducing_points({"n_inducing": 24}, x, SEEDS[0])
    assert z.shape == (24, CFG["input_dim"])
    assert torch.unique(z, dim=0).shape[0] == 24
    assert torch.equal(z, data.inducing_points({"n_inducing": 24}, x, SEEDS[0]))
