"""A cell on several cards is data: ``chips`` starts one rank a card through
``lvtbench.launch`` (here two gloo ranks on the CPU), each rank runs the
cell's kind with its rank and the world's size, and a rank's failure comes
back to the caller. The kinds of this benchmark run on one card and say so."""

import os
import time

import pytest

from lvtbench import launch


def test_ranks_run_the_kind_and_report_its_failure(tiny):
    os.environ["OMP_NUM_THREADS"] = "1"
    with pytest.raises(RuntimeError, match="runs on one card"):
        launch.spawn(2, tiny("train")._replace(chips=2), 7, 0.5, False, "cpu",
                     time.perf_counter(), timeout=300)
