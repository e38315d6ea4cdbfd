"""BENCHMARK.json against the benchmark's contract: names, units, keys and
bounds, and every file a cell, configuration, mix or metric is found by."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) for p in MAN["paths"])
    assert all(not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["configs"]) <= 24 and 1 <= len(MAN["workloads"]) <= 24
    assert 1 <= len(MAN["end_to_end"]) <= 16 and 1 <= len(MAN["per_layer"]) <= 128


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("why", "layer"):
            if key in e:
                assert _line(e[key]), (e["name"], key)
        if section == "configs":
            assert _line(e["source"]) and e["source"].startswith("https://")


def test_metric_names_are_unique():
    names = ([m["name"] for m in MAN["end_to_end"]] + [m["name"] for m in MAN["per_layer"]])
    assert len(names) == len(set(names))


def test_end_to_end_bounds_and_setup():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m["name"]
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_report_what_they_must():
    cells = {w["name"] for w in MAN["workloads"]}
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in MAN["end_to_end"]}
    for cell in cells:
        assert cell in e2e["setup_s"]
        assert any(cell in w for n, w in e2e.items() if n != "setup_s"), cell
        assert any(cell in m.get("workloads", cells) for m in MAN["per_layer"]), cell
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells and cell in e2e[m["moves"]], (m["name"], cell)


def test_per_layer_layers_and_rooflines():
    for m in MAN["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


def test_configs_and_cells():
    configs = {c["name"]: c for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for c in configs.values():
        assert c["file"].startswith(MAN["paths"][0] + "/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert set(c["reduced"]) == set(body["reduced"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        for key in c["reduced"]:
            assert not re.search(r"(_dim|_rank|d_model|d_ff|head|state|expand|top_k)", key)
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for w in MAN["workloads"]:
        assert _line(w["why"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_every_named_file_exists():
    bench = ROOT / "perfbench"
    for w in MAN["workloads"]:
        traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json").read_text())
        assert (bench / "drivers" / f"{traffic['driver']}.py").exists()
        limits = json.loads((bench / "limits" / f"{w['name']}.json").read_text())
        # an exact comparison has the limit 0
        assert limits and all(v >= 0 for v in limits.values())
    for m in MAN["per_layer"]:
        readers = {m["name"], m["name"].split(".")[0]}
        assert any((bench / "metrics" / f"{r}.py").exists() for r in readers), m["name"]


def test_check_fits_its_time():
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_no_card_means_no_result(tmp_path):
    """On a machine with no CUDA card a run exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cell = MAN["workloads"][0]["name"]
    out = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"),
                          "--workload", cell, "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True,
                         cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "correct" not in out.stdout

