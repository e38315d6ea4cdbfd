"""The harness finds every cell, configuration, mix and metric by its name:
a new one is a new file and a new entry, and no file that is there
changes."""

import json
import time

import torch

from perfbench import harness, testbench
from perfbench.trace import DeviceOp, Summary


def test_a_dummy_of_each_is_found(tmp_path):
    bench = testbench.build(tmp_path)
    man = bench.manifest
    man["configs"].append({"name": "dummy-config", "source": "https://example.org/x",
                           "file": "perfbench/configs/dummy-config.json",
                           "reduced": [], "why": "a dummy"})
    body = json.loads((tmp_path / "perfbench/configs/zamba2-2.7b.json").read_text())
    body["model"].update(n_layers=2, share_period=2, name="dummy-config")
    (tmp_path / "perfbench/configs/dummy-config.json").write_text(json.dumps(body))
    mix = {"driver": "score", "batch": 1, "seq": 32, "check_docs": 2, "trace_items": 1}
    (tmp_path / "perfbench/traffic/dummy-mix.json").write_text(json.dumps(mix))
    man["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                             "traffic": "dummy-mix", "chips": 1, "why": "a dummy"})
    (tmp_path / "perfbench/limits/dummy-cell.json").write_text(
        json.dumps({"score_loss_gap": 0.05}))
    man["end_to_end"][2].setdefault("workloads", []).append("dummy-cell")
    man["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "lower",
                             "source": "device_trace", "layer": "device",
                             "moves": man["end_to_end"][2]["name"],
                             "workloads": ["dummy-cell"]})
    man["per_layer"].append({"name": "dummy2.score", "unit": "%", "better": "lower",
                             "source": "device_trace", "layer": "device",
                             "moves": man["end_to_end"][2]["name"],
                             "workloads": ["dummy-cell"]})
    (tmp_path / "perfbench/metrics/dummy.metric.py").write_text(
        "def read(run):\n    return 42.0 if run.traced else None\n")
    # a reader for every metric whose name begins with ``dummy2.``
    (tmp_path / "perfbench/metrics/dummy2.py").write_text(
        "def read(run):\n    return 7.0 if run.traced else None\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))

    bench = harness.Bench.load(tmp_path, tmp_path / "perfbench")
    cell = bench.cell("dummy-cell")
    assert cell.config["model"]["name"] == "dummy-config"
    assert cell.traffic == mix and cell.driver.__name__.endswith("score")
    names = [m["name"] for m in bench.metrics_of("per_layer", "dummy-cell")]
    assert names == ["dummy.metric", "dummy2.score"]
    assert [m["name"] for m in bench.metrics_of("end_to_end", "dummy-cell")] == [
        man["end_to_end"][2]["name"], "setup_s"]

    result = harness.execute(cell, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {man["end_to_end"][2]["name"], "setup_s"}

    run = harness.Run(cell=cell, seed=3, seconds=0.0, trace=True,
                      device=torch.device("cpu"), t_start=0.0)
    run.traced = Summary(ops=[DeviceOp("k", 0.0, 1.0)], host=[], cpu=[], window_s=2.0,
                         counters={}, items=1)
    got = harness.read_metrics(run, bench.metrics_of("per_layer", "dummy-cell"))
    assert got == {"dummy.metric": {"value": 42.0, "unit": "%"},
                   "dummy2.score": {"value": 7.0, "unit": "%"}}
    run.traced = None
    assert harness.read_metrics(run, bench.metrics_of("per_layer", "dummy-cell")) == {}


def test_every_real_cell_loads():
    bench = harness.Bench.load()
    for w in bench.manifest["workloads"]:
        cell = bench.cell(w["name"])
        assert hasattr(cell.driver, "run") and hasattr(cell.driver, "control")
        assert harness.model_config(cell.config).name == cell.config["model"]["name"]
        for m in bench.metrics_of("per_layer", w["name"]):
            assert callable(bench.module("metrics", m["name"]).read)


def test_trace_summary_arithmetic():
    s = Summary(ops=[DeviceOp("a", 0.0, 1.0), DeviceOp("b", 0.5, 2.0),
                     DeviceOp("a", 3.0, 3.5)],
                host=[("node", 0.0, 2.0, 1.5)], cpu=[("host op", 2.0, 3.0)],
                window_s=4.0, counters={}, items=1)
    assert s.busy_s == 2.5 and s.device_s == 3.0
    assert s.gaps() == [(2.0, 3.0)]
    assert s.under_host(lambda n: n == "node") == 1.5
    b = s.breakdown()
    assert b["device_ops"] == [["a", 1.5], ["b", 1.5]]
    assert b["idle_gaps"] == [["host op", 1.0]]


def test_subseeds_differ_and_repeat():
    big = 2 ** 31 + 12345
    assert harness.subseed(big, 1) == harness.subseed(big, 1)
    assert len({harness.subseed(s, t) for s in (0, 1, big, -5) for t in (1, 2)}) == 8
    assert 0 <= harness.subseed(big, -1) < 2 ** 63
