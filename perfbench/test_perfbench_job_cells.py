"""The scoring and clustering cells at a miniature size on the CPU: a sound
run is correct, a control (the reference in the next precision below the
configuration's, in the program's place) fails one of the cell's numbers,
and a whole run with a fault planted under the timed path comes out not
correct: half the batch, an answer altered, in the scoring cell a slot
sent to the wrong expert or a wrong capacity rule, in the clustering cell
a fit stopped after one iteration."""

import pytest
import torch

from perfbench import harness, testbench

CELLS = ["mixtral-score", "zamba2-cluster"]


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return testbench.build(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(bench, cell):
    result = testbench.run_cell(bench, cell)
    assert result["correct"], result["compared"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["compared"]) == set(testbench.LIMITS[cell])


@pytest.mark.parametrize("cell,fault", [
    (cell, fault) for cell in CELLS for fault in ("half_batch", "alter")] + [
    ("mixtral-score", "route"), ("mixtral-score", "drops"), ("zamba2-cluster", "one_iter")])
def test_planted_fault_is_caught(bench, cell, fault):
    result = testbench.run_cell(bench, cell, fault=fault)
    assert not result["correct"], result["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(bench, cell, monkeypatch):
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    c = bench.cell(cell)
    run = harness.Run(cell=c, seed=7, seconds=0.0, trace=False,
                      device=torch.device("cpu"), t_start=0.0)
    run.model_cfg = harness.model_config(c.config)
    got = c.driver.control(run)
    limits = testbench.LIMITS[cell]
    assert all(v <= limits[k] for k, v in got["program"].items() if k in limits)
    controls = [v for k, v in got.items() if k.startswith("control")]
    assert controls and any(any(x > limits[k] for k, x in v.items() if k in limits)
                                for v in controls)
    faults = {"mixtral-score": ("half_batch", "alter", "route", "drops"),
              "zamba2-cluster": ("half_batch", "alter", "one_iter")}[cell]
    for fault in faults:
        assert any(x > limits[k] for k, x in got[fault].items() if k in limits), fault


@pytest.mark.parametrize("side", [0, 1])
def test_a_tied_row_may_go_to_either_center(side):
    """A row whose two nearest centers tie goes to the one the fit chose;
    a row that does not tie goes to its nearest all the same."""
    from perfbench.reference.kmeans import step_means
    x = torch.tensor([[-2.0, 0.0], [2.0, 0.0], [0.0, 1.0], [-1.9, 0.0]], dtype=torch.float64)
    prev = torch.tensor([[-1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    rows = [[0, 3, 2], [1]] if side == 0 else [[0, 3], [1, 2]]
    got = torch.stack([x[r].mean(0) for r in rows])
    assert torch.allclose(step_means(x, prev, got), got)
    wrong = torch.stack([x[[0]].mean(0), x[[1, 2, 3]].mean(0)])
    assert not torch.allclose(step_means(x, prev, wrong), wrong)
