"""The check that decides `correct`, driven through a whole run on the CPU
at a tiny size, the card's look skipped: the program reads as correct;
the control (the reference in a precision below the configuration's) and
each planted fault read as not correct under the committed limits."""

import time

import pytest

from portbench import harness

CELLS = ("tiny_loss", "tiny_train", "tiny_decode")


def _run(cell, seconds=0.3, program=None, seed=2**31 + 11):
    workload, config, mix = cell
    return harness.run_cell(workload, seed, seconds, False, time.time(),
                            device="cpu", config=config, mix=mix,
                            program=program)


def _entry(cell):
    return harness.entry_module(cell[2]["entry"])


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name, request):
    cell = request.getfixturevalue(name)
    line = _run(cell)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, request):
    cell = request.getfixturevalue(name)
    line = _run(cell, program=_entry(cell).control(cell[1]))
    assert not line["correct"], line["checks"]


FAULTS = [("tiny_loss", f) for f in ("half_batch", "cost_altered",
                                      "grad_altered")] + \
    [("tiny_train", f) for f in ("state_unchanged", "half_batch",
                                 "loss_altered", "count_frozen")] + \
    [("tiny_decode", f) for f in ("half_batch", "token_altered",
                                  "all_blank")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, request):
    cell = request.getfixturevalue(name)
    assert set(_entry(cell).FAULTS) == {f for n, f in FAULTS if n == name}
    line = _run(cell, program=_entry(cell).FAULTS[fault])
    assert not line["correct"], line["checks"]
