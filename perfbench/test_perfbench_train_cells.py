"""The training cells at a miniature size on the CPU: a sound run is
correct, the control (the reference with fp8 products in the program's
place) fails one of the cell's numbers, and a whole run with a fault
planted under the timed path comes out not correct: a state left
unchanged, half the batch, and in the sparse-expert cell a slot sent to
the wrong expert or a wrong capacity rule."""

import pytest
import torch

from perfbench import harness, testbench

CELLS = ["zamba2-train", "mixtral-train"]


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
    (cell, fault) for cell in CELLS for fault in ("unchanged", "half_batch")] + [
    ("mixtral-train", "route"), ("mixtral-train", "drops")])
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
    assert any(v > limits[k] for k, v in got["control_fp8"].items() if k in limits)
    assert any(v > limits[k] for k, v in got["fault_half_batch"].items() if k in limits)
    for fault in ("route", "drops"):
        if fault in got:
            assert any(v > limits[k] for k, v in got[fault].items() if k in limits), fault
    assert ("route" in got) == (cell == "mixtral-train")
