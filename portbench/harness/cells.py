"""Find a cell's files by name.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``, the
parameters its driver's generator reads) and its driver
(``drivers/<driver>.py``), and holds the limits of its checks. A
per-layer metric is ``metrics/<metric>.py``. Nothing here lists them: a
new file is found by its name.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(name: str, bench: Path = BENCH_DIR) -> dict:
    cell = load_json(bench / "workloads" / f"{_check_name(name)}.json")
    if cell.get("name") != name:
        raise ValueError(f"workloads/{name}.json names {cell.get('name')!r}")
    return cell


def config(name: str, bench: Path = BENCH_DIR) -> dict:
    """The configuration as it is run: the file's keys, which are the
    source's, with those under ``as_run`` (where the program cannot take
    the source's value) put over them."""
    cfg = load_json(bench / "configs" / f"{_check_name(name)}.json")
    if cfg.get("name") != name:
        raise ValueError(f"configs/{name}.json names {cfg.get('name')!r}")
    return {**cfg, **cfg.get("as_run", {})}


def traffic(name: str, bench: Path = BENCH_DIR) -> dict:
    mix = load_json(bench / "traffic" / f"{_check_name(name)}.json")
    if mix.get("name") != name:
        raise ValueError(f"traffic/{name}.json names {mix.get('name')!r}")
    return mix


def workload_names(bench: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (bench / "workloads").glob("*.json"))


def _module(path: Path, qualname: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(qualname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[qualname] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(name: str, bench: Path = BENCH_DIR) -> ModuleType:
    """``drivers/<name>.py``: a module with ``run(ctx)``."""
    return _module(bench / "drivers" / f"{_check_name(name)}.py",
                   f"portbench_driver_{name}")


def metric_names(bench: Path = BENCH_DIR) -> List[str]:
    return sorted(p.stem for p in (bench / "metrics").glob("*.py")
                  if not p.stem.startswith("_"))


def metric(name: str, bench: Path = BENCH_DIR) -> ModuleType:
    """``metrics/<name>.py``: a module with ``LAYER``, ``UNIT``,
    ``BETTER``, ``SOURCE``, ``MOVES``, ``applies(cell)`` (whether it
    reads something in a cell, given the cell's file) and ``read(run)``,
    which returns a number or None."""
    return _module(bench / "metrics" / f"{_check_name(name)}.py",
                   "portbench_metric_" + name.replace(".", "_"))


def metrics_for(cell: str, bench: Path = BENCH_DIR) -> Dict[str, ModuleType]:
    """Every per-layer metric that applies to ``cell``."""
    spec = workload(cell, bench)
    out = {}
    for name in metric_names(bench):
        mod = metric(name, bench)
        if mod.applies(spec):
            out[name] = mod
    return out
