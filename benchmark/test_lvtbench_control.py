"""The controls of the correctness check fail it: the reference put in the
program's place in the precision below the configuration's. At the cells'
sizes on the card ``calibrate.py`` reads them over seeds; here a tiny
float32 configuration holds its TF32 control, and the fp8 control of the
bf16 cells, to the tiny cell's limits."""

import pytest

from conftest import TINY_CONFIG, TINY_GEN_LIMITS, TINY_TRAIN_LIMITS, TINY_TRAIN_TRAFFIC
from lvtbench import checks
from reference.precision import FP8, TF32
from test_lvtbench_reference import SEED, _served


def _fails(numbers, limits):
    return any(numbers[k] > lim for k, lim in limits["limits"].items() if k in numbers)


@pytest.mark.parametrize("control", [TF32, FP8], ids=["tf32", "fp8"])
def test_generation_control_fails(control):
    numbers = checks.gen_numbers(TINY_CONFIG, SEED, _served(rows=4), 4, "cpu", control,
                                 control)
    assert _fails(numbers, TINY_GEN_LIMITS), numbers


@pytest.mark.parametrize("control", [TF32, FP8], ids=["tf32", "fp8"])
def test_training_control_fails(control):
    ref = checks.train_reference(TINY_CONFIG, TINY_TRAIN_TRAFFIC, SEED, 9, "cpu", 3)
    got = checks.train_reference(TINY_CONFIG, TINY_TRAIN_TRAFFIC, SEED, 9, "cpu", 3, control)
    assert _fails(checks.train_numbers(got, ref), TINY_TRAIN_LIMITS)


@pytest.mark.parametrize("fault", ["half_batch", "token"])
def test_training_faults_fail(fault):
    ref = checks.train_reference(TINY_CONFIG, TINY_TRAIN_TRAFFIC, SEED, 9, "cpu", 3)
    got = checks.train_reference(TINY_CONFIG, TINY_TRAIN_TRAFFIC, SEED, 9, "cpu", 3, fault=fault)
    assert _fails(checks.train_numbers(got, ref), TINY_TRAIN_LIMITS)


def test_unchanged_state_reads_one():
    ref = checks.train_reference(TINY_CONFIG, TINY_TRAIN_TRAFFIC, SEED, 9, "cpu", 3)
    got = dict(ref, update=[0.0] * len(ref["update"]))
    assert checks.train_numbers(got, ref)["update_gap"] == pytest.approx(1.0)
