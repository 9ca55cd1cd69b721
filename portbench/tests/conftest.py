"""Fixtures of the benchmark's CPU tests: a copy of ``portbench/`` cut to a
tiny size, with limits for that size, in a temporary directory.

Run them with ``python -m pytest portbench/tests`` from the root of the
repository (``testpaths`` keeps them out of the repository's own run).
Tests that need a card are marked ``cuda`` and skip without one.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
            head_dim=16, num_hidden_layers=2, vocab_size=256)
# the limit at the tiny size (the cells' own are set at theirs)
TINY_ROW_ERR_MAX = 0.1


def make_tiny(dst: Path) -> Path:
    """A copy of the benchmark at a tiny size: 2 layers of width 64, a
    256-token vocabulary, [2, 64] prompts, 16 rows checked a call; every
    cell of the copy's ``workloads/`` kept."""
    shutil.copytree(BENCH, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for p in (dst / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c.update(TINY, num_key_value_heads=2 if c["num_key_value_heads"]
                 < c["num_attention_heads"] else 4)
        p.write_text(json.dumps(c))
    for p in (dst / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        t.update(seq=64, batch=min(t["batch"], 2))
        p.write_text(json.dumps(t))
    for p in (dst / "workloads").glob("*.json"):
        w = json.loads(p.read_text())
        w["check"].update(rows=16, row_err_max=TINY_ROW_ERR_MAX)
        p.write_text(json.dumps(w))
    return dst


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return make_tiny(tmp_path_factory.mktemp("portbench") / "portbench")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
