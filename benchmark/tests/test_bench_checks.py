"""The correctness check fails what it has to fail, at a size the CPU
holds: the control (the reference one precision step below the
configuration's, in the program's place) and each fault a training cell
can have, planted underneath a whole run."""

import time

import pytest
import torch

from benchmark.harness import correct, spec
from benchmark.harness.run_cell import first_iteration, reference_side, release, run
from benchmark.tests._tiny import tiny

torch.set_num_threads(1)
CELLS = [w["name"] for w in spec.benchmark_json()["workloads"]]
FAULTS = ("frozen_step", "half_batch", "altered_action")


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_and_the_program_is(name):
    # 16 envs x 32 steps: at 4 x 8 too few acts flip under the control for
    # the HF cell's limits to see it
    cell = tiny(name, envs=16, steps=32)
    job, cap = first_iteration(cell, 31, "cpu")
    hp = job.hp
    release(job, "cpu")
    ref = reference_side(hp, 31, cap, "cpu")
    ctl = reference_side(hp, 31, cap, "cpu", lower=True)
    nums = correct.numbers(ctl, ref, correct.own_actions(ctl))
    assert not correct.judge(nums, cell["limits"]), nums
    nums = correct.numbers(cap, ref, cap["actions"])
    assert correct.judge(nums, cell["limits"]), nums


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_a_fault_underneath_is_not_correct(name, fault):
    res = run(tiny(name), 37, 0.01, False, "cpu", time.perf_counter(), lambda s: None,
              fault=fault)
    assert res["correct"] is False, res["numbers"]
