"""Runs of each cell at a size the CPU holds, through the harness (the
look for a chip skipped): the program against the plain reference, the
control and every planted fault (portbench/faults.py) caught."""
import pytest

from portbench import faults
from portbench_tiny import run, tiny_query, tiny_train


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_fd_query_correct(seed):
    res = run(tiny_query(), seed)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"topk_queries_s", "query_p95_ms",
                                   "setup_s"}
    assert list(res)[-1] == "checks"


def test_fd_query_control_fails():
    res = run(tiny_query(), 3, control=True)
    assert not res["correct"]
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("fault", faults.QUERY)
def test_fd_query_fault_caught(fault):
    with faults.planted(fault, "fd_query"):
        res = run(tiny_query(), 4)
    assert not res["correct"], (fault, res["checks"])


def test_train_correct():
    res = run(tiny_train(), 2 ** 31 + 11)
    assert res["correct"], res["checks"]
    # the smoke model is f32 on both sides: the gaps are f32 round-off
    for chk in res["checks"].values():
        assert chk["value"] < 1e-4
    assert set(res["metrics"]) == {"train_tok_s", "setup_s"}


def test_train_sft_cell_correct():
    c = tiny_train("granite-sft-512")
    c.traffic.update(seq=16, batch=8)
    res = run(c, 5)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_train_fault_caught(fault):
    with faults.planted(fault, "train"):
        res = run(tiny_train(), 6)
    assert not res["correct"], (fault, res["checks"])


def test_train_control_fails():
    """The control (the reference computed in fp8) in the program's
    place reads above the limits."""
    from portbench.controls import readings
    res = readings(tiny_train(), 9, 0, "cpu", control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.card
def test_fd_query_on_the_card(card):
    """fd-query-64 at its own size on a card, 3 s windows: the program
    correct, its bf16 path (the control) not."""
    import time

    from portbench import harness
    c = harness.cell("fd-query-64")
    ok = harness.execute(c, 11, 3.0, False, card, time.perf_counter())
    assert ok["correct"], ok["checks"]
    bad = harness.execute(c, 12, 3.0, False, card, time.perf_counter(),
                          control=True)
    assert not bad["correct"]
