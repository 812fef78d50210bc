"""On a card: the tiny cells through the program's kernels (the fused MBConv
and flash attention run only there) against the reference, and each cell's
control refused by the same limits. Skipped without a card."""

import time

import pytest

from portbench.harness import compare

# each cell's control: the reference in the precision below the cell's (PERF.md section 4)
CONTROL = {"b5_pretrain_b8": "fp8", "vit_pretrain_b8": "fp8", "b5_embed_b16": "bf16"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["b5_pretrain_b8", "vit_pretrain_b8", "b5_embed_b16"])
def test_tiny_cell_on_the_card(card, tiny_cell, workload):
    cell = tiny_cell(workload)
    outcome = cell.loop().run(cell, 2 ** 31 + 11, 1.0, True, time.perf_counter(), device=card)
    assert outcome.attempted > 0 and outcome.device["platform"] == "gpu"
    assert outcome.run.profile is not None and outcome.run.profile.busy_s() > 0
    control = CONTROL[workload]
    readings = cell.loop().readings(cell, 2 ** 31 + 12, card, (control,))
    assert not compare.passed(compare.judge(readings[control], cell.limits))
