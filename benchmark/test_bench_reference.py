"""The comparison that decides ``correct``, rehearsed on the CPU at tiny
sizes: the port's plain version of the rollout kernel (``FastRollout`` on
a CPU batch) and its general path (``jit_rollout``) against the
benchmark's reference, for both configurations; the bfloat16 control
against it; and each fault a cell can have, planted under the timed
path, seen as not correct.  The card tests run the same at the cells'
own sizes."""

import pytest
import torch

from benchmark import faults
from benchmark.conftest import tiny_cell
from benchmark.run import run_cell
from benchmark.spec import load_cell

CELLS = ["cheetah-run.policy-obs", "cheetah-run.ctrl",
         "cheetah-run.general", "humanoid-run.policy-obs"]
SEED = 2 ** 31 + 12345


def rehearse(name, control=False, batch=None):
    cell, sizes = tiny_cell(name)
    if batch:
        sizes = (batch, sizes[1])
    return run_cell(cell, SEED, 0.01, False, "cpu", sizes=sizes,
                    judge_control=control)


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference(name):
    r = rehearse(name)
    assert r["correct"], r["check"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["check"]) == set(load_cell(name).limits)


@pytest.mark.parametrize("name", CELLS)
def test_the_bfloat16_control_is_not_correct(name):
    r = rehearse(name, control=True)
    assert not r["correct"], r["check"]


# ----- faults planted under the timed path --------------------------------


@pytest.mark.parametrize("fault", faults.KINDS)
@pytest.mark.parametrize("name", ["cheetah-run.policy-obs",
                                  "cheetah-run.ctrl",
                                  "cheetah-run.general"])
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    # a batch of 32, so that the faults in a share of the envs hit one
    # env (tail32) or four (every8)
    with faults.planted(fault):
        r = rehearse(name, batch=32)
    assert not r["correct"], r["check"]


# ----- on the card, at the cells' own sizes -------------------------------


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_port_is_correct_and_the_control_is_not(card, name):
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = load_cell(name)
    # a 1 s window: the time limit falls in its first call
    cell.traffic = dict(cell.traffic, limit_at_call=[0, 0])
    assert run_cell(cell, SEED, 1.0, False, card)["correct"]
    assert not run_cell(cell, SEED + 1, 1.0, False, card,
                        judge_control=True)["correct"]


def test_a_window_that_meets_no_time_limit_is_not_correct():
    cell, sizes = tiny_cell("cheetah-run.policy-obs")
    # the episodes end at the fifth timed call, after the window's one
    cell.config = dict(cell.config, episode_steps=10 ** 6,
                       time_limit_s=cell.config["timestep"] * 10 ** 6)
    cell.traffic = dict(cell.traffic, limit_at_call=[5, 5])
    r = run_cell(cell, SEED, 0.01, False, "cpu", sizes=sizes)
    assert not r["notes"]["checked"]["crossing"]
    assert not r["correct"]
