r"""The control of each cell comes out not correct: the reference put in
the program's place one step of precision below what the configuration
states (``portbench/control.py``), at the cell's own size, on three seeds,
fails at least one of the numbers the cell holds. On the card:

    python3 -m pytest portbench/tests -m card
"""

import json
import os

import pytest

from portbench import check
from portbench.control import control_numbers
from portbench.harness import ROOT, Context

CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
SEEDS = (2147483701, 3000000011, 4000000013)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed, card):
    from portbench import run
    run._environment()
    ctx = Context(cell, seed, 1.0, False)
    numbers = control_numbers(ctx, card)
    correct, checks = check.judge(numbers, check.load_limits(ROOT, cell))
    assert not correct, checks
