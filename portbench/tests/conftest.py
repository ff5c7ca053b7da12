"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (a few sensors in a small basin, so that they reach
their fogs), and the card check for the ``cuda``-marked tests."""
from __future__ import annotations

import copy

import pytest
import torch

from portbench import harness

SEED = 2**31 + 12345          # above 32 signed bits, as the driver's seeds are


def tiny(cell: harness.Cell, trials: int | None = None) -> harness.Cell:
    c = copy.deepcopy(cell)
    c.cfg["deployment"].update(n_sensors=12, n_fog=3, lx_m=400.0, ly_m=400.0, depth_m=300.0,
                               sensor_depth=[150.0, 300.0], fog_depth=[50.0, 150.0])
    c.cfg["data"].update(train_len=64, val_len=16, test_len=32)
    c.cfg["training"]["rounds"] = 3
    if c.mix["trials"] > 1:
        c.mix["trials"] = trials or 2
    if c.mix.get("client_chunk"):
        c.mix["client_chunk"] = 5
    return c


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def bench():
    return harness.Bench()


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 CUDA card")
    return torch.device("cuda", 0)
