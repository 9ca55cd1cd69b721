"""BENCHMARK.json and the files under portbench/ agree, and a cell, a
configuration and a per-layer metric are each added as new files only."""

import json
import re
import shutil

import pytest

from portbench.harness import cells
from portbench.tests.conftest import BENCH, ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"]
    assert SPEC["paths"] == ["portbench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in SPEC["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and w["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    f = cells.workload(cell)
    assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
        w["config"], w["traffic"], w["chips"], w["why"])
    conf = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert conf["file"] == f"portbench/configs/{w['config']}.json"
    c = cells.config(w["config"])
    assert c["source"] == conf["source"] and c["reduced"] == conf["reduced"]
    cells.traffic(f["traffic"])
    assert (BENCH / "drivers" / f"{f['driver']}.py").is_file()


def test_files_are_listed():
    assert cells.workload_names() == sorted(CELLS)
    assert cells.metric_names() == sorted(m["name"]
                                          for m in SPEC["per_layer"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_metric_files(metric):
    m = next(x for x in SPEC["per_layer"] if x["name"] == metric)
    mod = cells.metric(metric)
    assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == (
        m["layer"], m["unit"], m["better"], m["source"], m["moves"])
    assert sorted(c for c in CELLS if mod.applies(cells.workload(c))) \
        == sorted(m["workloads"])
    e2e = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
    assert set(m["workloads"]) <= set(e2e.get("workloads", CELLS))


def test_layers_are_perf_md_s():
    """Each metric's layer is a row of PERF.md's list of layers."""
    text = (ROOT / "PERF.md").read_text()
    rows = {line.split("|")[1].strip() for line in text.splitlines()
            if line.startswith("| ") and line.count("|") == 5}
    for m in SPEC["per_layer"]:
        assert m["layer"] in rows, m["layer"]


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "portbench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    cfg = json.loads((bench / "configs" / "yi-6b.json").read_text())
    (bench / "configs" / "new-config.json").write_text(
        json.dumps(dict(cfg, name="new-config")))
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(
        {"name": "new-mix", "batch": 1, "seq": 128}))
    (bench / "workloads" / "new-cell.json").write_text(json.dumps(
        {"name": "new-cell", "config": "new-config", "traffic": "new-mix",
         "driver": "prefill", "chips": 1, "why": "added as files",
         "check": {"calls": 1, "among": 1, "rows": 8,
                   "row_err_max": 0.1}}))
    (bench / "metrics" / "new_metric.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nBETTER = "lower"\n'
        'SOURCE = "device_trace"\nMOVES = "prefill_tok_s"\n\n\n'
        'def applies(cell):\n    return cell["name"] == "new-cell"\n\n\n'
        'def read(run):\n    return 1.0\n')
    assert "new-cell" in cells.workload_names(bench)
    assert cells.config("new-config", bench)["name"] == "new-config"
    assert cells.traffic("new-mix", bench)["seq"] == 128
    found = cells.metrics_for("new-cell", bench)
    assert "new_metric" in found and "flash_roofline" in found
    assert cells.driver("prefill", bench).run
    # the repository's own files are untouched
    assert "new-cell" not in cells.workload_names()
