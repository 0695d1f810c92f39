"""Test settings of the benchmark's own tests.

Tests that need a CUDA card carry the ``card`` marker and take the
``card`` fixture, which skips them where there is none; they run on the
card with ``python3 -m pytest benchmark/ -q -m card``.
"""

import pytest
import torch

from benchmark.spec import load_cell

# the CPU rehearsal's sizes: (B, K), with episodes of EPISODE steps so
# that the calls cross the time limit
TINY = {"cheetah-run": (8, 6), "humanoid-run": (4, 3)}
EPISODE = 7


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this machine has none")
    return torch.device("cuda", 0)


def tiny_cell(name: str):
    """The cell ``name`` with its episodes cut to EPISODE steps, and its
    rehearsal sizes."""
    cell = load_cell(name)
    cfg = cell.config
    cell.config = dict(cfg, time_limit_s=cfg["timestep"] * EPISODE,
                       episode_steps=EPISODE)
    # the rehearsal's window holds one call: it crosses the time limit
    cell.traffic = dict(cell.traffic, limit_at_call=[0, 0])
    return cell, TINY[cfg["name"]]
