"""What decides `correct`, on the CPU at tiny sizes: the plain reference
agrees with the port (float32, so the two differ by round-off alone) over a
training cell's checked steps and an eval cell's checked answers; a run
with its timed path broken underneath reads `correct` false; the control,
the reference in the precision below the configuration's in the program's
place, fails a number."""
from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.lib import judge, manifest
from portbench.lib.pretrain import PretrainCell
from portbench.lib.zeroshot import ZeroShotCell
from portbench.tests import tiny

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def test_reference_agrees_with_the_port_over_three_steps(root):
    line = run.run(tiny.args(tiny.TRAIN_CELL), root=root, device=CPU)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"] and line["attempted"] >= 1
    assert checks["loss_gap"] < 1e-5 and checks["grad_gap"] < 1e-4
    assert checks["change_gap"] < 1e-4 and checks["trainable_mismatch"] == 0


def test_reference_agrees_with_the_port_on_the_eval_answers(root):
    line = run.run(tiny.args(tiny.EVAL_CELL, seconds=1.0), root=root, device=CPU)
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert line["correct"], checks
    assert checks["logit_gap"] < 1e-6 and checks["label_mismatch"] == 0
    assert checks["unchecked"] == 0


@pytest.mark.parametrize("cell,fault", [(tiny.TRAIN_CELL, "state_unchanged"),
                                        (tiny.TRAIN_CELL, "half_batch"),
                                        (tiny.EVAL_CELL, "answer_altered"),
                                        (tiny.EVAL_CELL, "half_batch")])
def test_a_broken_timed_path_reads_incorrect(root, cell, fault):
    line = run.run(tiny.args(cell, seconds=1.0), root=root, device=CPU, fault=fault)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell", [tiny.TRAIN_CELL, tiny.EVAL_CELL])
def test_the_control_fails_a_number(root, cell):
    c = manifest.cell(cell, root)
    runner = {"pretrain": PretrainCell, "zeroshot_eval": ZeroShotCell}[c.traffic["kind"]](
        c, 2 ** 31 + 29, CPU)
    runner.setup()
    runner.window(1.0, False)
    runner.release()
    numbers = runner.control_numbers(c.traffic["control"])
    assert not judge.verdict(numbers, c.limits), numbers
